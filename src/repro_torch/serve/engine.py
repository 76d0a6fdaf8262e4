"""ServeEngine: continuous-batching greedy inference over a KV cache
(mirror of ``repro.serve.engine``, direct mode).

With ``kv_layout="paged"`` (the default) the engine owns a shared **page
pool** per layer (``[num_pages, page_size, KV, D]``) plus a per-slot
**block table** (``[max_slots, max_pages] int32``, vLLM-style): a
sequence's KV lives in whatever physical pages its table points at, and
admission reserves a prompt's pages from a free list that
``_finish_slot`` refills.  With ``kv_layout="contiguous"`` every slot owns
one ``[max_len, KV, D]`` row per layer (the JAX engine's benchmark
baseline).  Each ``step()`` spends at most ``prefill_chunk_tokens``
prompt tokens across the prefilling slots in one ragged chunk forward
(the prefill kernel writes every row's chunk at its own offset, straight
into the cache), then runs one fused decode over the slots whose prefill
already finished.  Chunk widths and block-table widths are bucketed to
powers of two exactly as in the JAX engine, so both engines run the same
shapes.

Differences from the JAX engine:

* everything runs on ``device`` (default ``"cuda"``; without a GPU the
  default raises, only an explicit ``device="cpu"`` runs on the CPU);
* the caches are updated in place instead of being donated; a
  contiguous decode step gives the rows that must not decode length -1,
  so their appends drop and they read nothing (JAX writes them and
  restores the old rows with a ``where`` over the whole cache);
* prefill-only engines and KV handoffs, ``run_service`` and fault
  injection are later slices and raise ``NotImplementedError``
  (ROADMAP.md queue 1, items 7 and 11);
* only greedy decoding is served: ``temperature > 0`` raises at
  ``submit`` (seeded streams need threefry, ROADMAP.md queue 3).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.params import init_params, map_tree, tree_bytes
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.lm import lm_cache_specs, lm_paged_cache_specs
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.sampling import make_slot_key
from repro_torch.train.state import model_specs
from repro_torch.train.step import make_decode_step, make_prefill_chunk_step

_engine_uid = itertools.count()


def _bucket(n: int, lo: int = 2) -> int:
    """Next power-of-two >= n (floored at ``lo``): the JAX engine's shape
    buckets, kept so both engines run the same shapes."""
    p = lo
    while p < n:
        p *= 2
    return p


class ServeEngine:
    """Continuous-batching engine for dense GQA token LMs over a paged or
    contiguous KV cache, driven directly (``submit`` + ``step`` /
    ``run_until_drained``)."""

    def __init__(self, cfg: ModelConfig, run_cfg: Optional[RunConfig] = None,
                 *, max_slots: int = 4, max_len: int = 128,
                 params: Any = None, seed: int = 0,
                 continuous: bool = True, kv_layout: str = "paged",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 decode_impl: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = 64,
                 prefill_only: bool = False,
                 name: Optional[str] = None, device=None):
        if cfg.is_encoder_decoder or cfg.input_kind != "tokens":
            raise NotImplementedError("ServeEngine targets token-LM archs")
        if cfg.mrope_sections:
            raise NotImplementedError(
                "M-RoPE position streams are not supported by the slot cache")
        if max_slots < 1 or max_len < 2:
            raise ValueError("need max_slots >= 1 and max_len >= 2")
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if prefill_only and kv_layout != "paged":
            raise ValueError("prefill_only engines require kv_layout="
                             "'paged' (handoff ships page blocks)")
        if prefill_only:
            raise NotImplementedError(
                "prefill-only engines and KV handoffs are the fleet slice "
                "(ROADMAP.md queue 1, item 7)")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1 (or None "
                             "for whole-prompt prefill)")
        if decode_impl is not None:
            cfg = cfg.with_overrides(decode_impl=decode_impl)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run_cfg = run_cfg or RunConfig()
        self.uid = name or f"engine{next(_engine_uid):03d}"
        self.max_slots = max_slots
        self.max_len = max_len
        self.continuous = continuous
        self.paged = kv_layout == "paged"
        self.page_size = page_size
        self.max_pages = -(-max_len // page_size)
        # per-step prompt-token budget for chunked prefill; None = each
        # prompt prefills in one chunk (the unchunked baseline)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # full backing by default; pass a smaller num_pages to overcommit
        self.num_pages = (num_pages if num_pages is not None
                          else max_slots * self.max_pages)
        # raises for archs the port does not serve yet
        specs = model_specs(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, specs, self.device)
        self.params = params
        # every weight is cast to the compute dtype where it is used, so
        # casting the tree once here computes exactly the same function
        self._run_params = map_tree(lambda t: t.to(self.device, cfg.compute_dtype),
                                    params)
        self._prefill_chunk = make_prefill_chunk_step(cfg, self.run_cfg)
        self._decode = make_decode_step(cfg, self.run_cfg)

        # _lock guards the state shared with submitter/monitor threads
        # (queue, stats, shape tracking); the slot/page fields are owned by
        # the thread that calls step()
        self._lock = threading.Lock()
        self.queue: Deque[Request] = collections.deque()  # guarded-by: _lock
        self._stats: Dict[str, int] = collections.defaultdict(int)  # guarded-by: _lock
        self._seen_shapes: Dict[str, set] = collections.defaultdict(set)  # guarded-by: _lock
        self._init_state()
        self._cache_bytes = tree_bytes(self.cache)
        self._page_bytes = self._cache_bytes // self.num_pages if self.paged else 0

    # -- state lifecycle -----------------------------------------------------

    def _init_state(self) -> None:
        if self.paged:
            specs = lm_paged_cache_specs(self.cfg, self.num_pages, self.page_size)
            # per-slot block tables; sentinel num_pages = unallocated
            self.block_table = np.full((self.max_slots, self.max_pages),
                                       self.num_pages, np.int32)
            self.free_pages: List[int] = list(range(self.num_pages))
            self.slot_pages: List[List[int]] = [[] for _ in range(self.max_slots)]
        else:
            specs = lm_cache_specs(self.cfg, self.max_slots, self.max_len)
        self.cache = map_tree(
            lambda p: torch.zeros(p.shape, dtype=p.dtype, device=self.device),
            specs)
        self.lengths = np.zeros(self.max_slots, np.int32)
        self.last_tok = np.zeros(self.max_slots, np.int32)
        self.slots: List[Optional[Request]] = [None] * self.max_slots
        self.slot_keys = np.zeros((self.max_slots, 2), np.uint32)
        self.slot_temp = np.zeros(self.max_slots, np.float32)
        self.slot_topk = np.zeros(self.max_slots, np.int32)
        # chunked-prefill progress: tokens of the prompt already written
        # into the cache, or -1 once the slot is decoding / free
        self.prefill_pos = np.full(self.max_slots, -1, np.int32)
        self.slot_prompt: List[Optional[np.ndarray]] = [None] * self.max_slots

    def checkpoint(self) -> Dict[str, Any]:
        """Snapshot the full serving state (page pool, block tables and
        free list when paged, the slot cache otherwise; per-slot lengths
        and keys; bound and queued requests).  The caches are cloned:
        later steps write the live ones in place."""
        with self._lock:
            state = {
                "cache": map_tree(torch.clone, self.cache),
                "lengths": self.lengths.copy(),
                "last_tok": self.last_tok.copy(),
                "slots": list(self.slots),
                "queue": list(self.queue),
                "stats": dict(self._stats),
                "slot_keys": self.slot_keys.copy(),
                "slot_temp": self.slot_temp.copy(),
                "slot_topk": self.slot_topk.copy(),
                "prefill_pos": self.prefill_pos.copy(),
                "slot_prompt": list(self.slot_prompt),
            }
            if self.paged:
                state.update({
                    "block_table": self.block_table.copy(),
                    "free_pages": list(self.free_pages),
                    "slot_pages": [list(p) for p in self.slot_pages],
                })
            return state

    def restore(self, state: Dict[str, Any]) -> None:
        with self._lock:
            # clone: ``state`` may be restored again later, and the live
            # pools are written in place
            self.cache = map_tree(torch.clone, state["cache"])
            self.lengths = state["lengths"].copy()
            self.last_tok = state["last_tok"].copy()
            self.slots = list(state["slots"])
            self.queue = collections.deque(state["queue"])
            self._stats = collections.defaultdict(int, state["stats"])
            self.slot_keys = state["slot_keys"].copy()
            self.slot_temp = state["slot_temp"].copy()
            self.slot_topk = state["slot_topk"].copy()
            self.prefill_pos = state["prefill_pos"].copy()
            self.slot_prompt = list(state["slot_prompt"])
            if self.paged:
                self.block_table = state["block_table"].copy()
                self.free_pages = list(state["free_pages"])
                self.slot_pages = [list(p) for p in state["slot_pages"]]

    def _release_state(self) -> None:
        """Drop the live slot state (after checkpointing)."""
        with self._lock:
            self.cache = None
            self.slots = [None] * self.max_slots
            self.lengths = np.zeros(self.max_slots, np.int32)
            self.last_tok = np.zeros(self.max_slots, np.int32)
            self.queue = collections.deque()
            self.slot_keys = np.zeros((self.max_slots, 2), np.uint32)
            self.slot_temp = np.zeros(self.max_slots, np.float32)
            self.slot_topk = np.zeros(self.max_slots, np.int32)
            self.prefill_pos = np.full(self.max_slots, -1, np.int32)
            self.slot_prompt = [None] * self.max_slots
            if self.paged:
                self.block_table = np.full((self.max_slots, self.max_pages),
                                           self.num_pages, np.int32)
                self.free_pages = list(range(self.num_pages))
                self.slot_pages = [[] for _ in range(self.max_slots)]

    # -- client side ---------------------------------------------------------

    def submit(self, request, **kw) -> Request:
        """Queue a request (a :class:`Request` or a raw prompt array)."""
        if not isinstance(request, Request):
            request = Request(np.asarray(request, np.int32), **kw)
        if request.temperature > 0:
            raise NotImplementedError(
                "the port serves greedy requests only: seeded sampling "
                "needs threefry ported (ROADMAP.md queue 3)")
        with self._lock:
            self.queue.append(request)
        return request

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.queue) or any(r is not None for r in self.slots)

    def occupancy(self) -> int:
        with self._lock:  # cross-thread monitoring read
            return sum(r is not None for r in self.slots)

    def pages_in_use(self) -> int:
        with self._lock:  # cross-thread monitoring read
            return self.num_pages - len(self.free_pages) if self.paged else 0

    def admission_signals(self) -> Dict[str, Any]:
        """One-lock snapshot of the signals a fleet router admits on: slot
        occupancy, page-pool pressure, and queue depth and age.  For a
        contiguous engine the page figures are free slots (each slot owns
        its full row, so slots are the only capacity axis)."""
        with self._lock:
            now = time.time()
            occupied = sum(r is not None for r in self.slots)
            return {
                "engine": self.uid,
                "prefill_only": False,
                "occupied": occupied,
                "max_slots": self.max_slots,
                "queue_depth": len(self.queue),
                "oldest_queued_age_s": (
                    now - min(r.submitted_at for r in self.queue)
                    if self.queue else 0.0),
                "free_pages": (len(self.free_pages) if self.paged
                               else self.max_slots - occupied),
                "num_pages": self.num_pages if self.paged else self.max_slots,
            }

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    # -- page bookkeeping ----------------------------------------------------

    def _count_retrace(self, kind: str, key) -> None:
        """Count each new shape bucket (a retrace in the JAX engine)."""
        with self._lock:
            seen = self._seen_shapes[kind]
            if key not in seen:
                seen.add(key)
                self._stats["retraces"] += 1
                self._stats[f"retraces_{kind}"] += 1

    def _alloc_pages(self, slot: int, n: int) -> bool:
        """Append ``n`` fresh pages to a slot's block table (False if the
        pool cannot supply them; the caller backpressures or fails)."""
        if len(self.free_pages) < n:
            return False
        base = len(self.slot_pages[slot])
        if base + n > self.max_pages:
            return False
        for j in range(n):
            pid = self.free_pages.pop()
            self.slot_pages[slot].append(pid)
            self.block_table[slot, base + j] = pid
        used = self.pages_in_use()
        with self._lock:
            if used > self._stats.get("peak_pages", 0):
                self._stats["peak_pages"] = used
        return True

    def _free_slot_pages(self, slot: int) -> None:
        self.free_pages.extend(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.block_table[slot, :] = self.num_pages

    def _ensure_decode_pages(self) -> None:
        """Every decoding slot appends K/V at position ``lengths[i]`` this
        step: allocate the covering page if the sequence just crossed a
        page boundary.  A slot the pool cannot serve fails (its pages
        return to the free list)."""
        for i, req in enumerate(self.slots):
            if req is None or self.prefill_pos[i] >= 0:
                continue
            lp = int(self.lengths[i]) // self.page_size
            if lp < len(self.slot_pages[i]):
                continue
            if not self._alloc_pages(i, 1):
                self._finish_slot(
                    i, RequestState.FAILED,
                    f"page pool exhausted ({self.num_pages} pages of "
                    f"{self.page_size}); lower the load or raise num_pages")

    # -- engine core ---------------------------------------------------------

    def _finish_slot(self, i: int, state: RequestState,
                     error: Optional[str] = None) -> None:
        req = self.slots[i]
        self.slots[i] = None
        self.lengths[i] = 0
        self.last_tok[i] = 0
        self.slot_temp[i] = 0.0
        self.slot_topk[i] = 0
        self.slot_keys[i] = 0
        self.prefill_pos[i] = -1
        self.slot_prompt[i] = None
        if self.paged:
            self._free_slot_pages(i)
        req._finish(state, error)
        self._bump("completed" if state is RequestState.DONE else "failed")

    def _should_stop(self, req: Request, tok: int, length: int) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (req.stop_token is not None and tok == req.stop_token)
                or length >= self.max_len)

    def _admit(self) -> int:
        """Bind queued requests to free slots, reserving their prompt
        pages when paged; the prompt itself is processed chunk by chunk in
        ``_prefill_step``.  Returns the number admitted."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        with self._lock:
            if not free or not self.queue:
                return 0
            if not self.continuous and len(free) < self.max_slots:
                return 0  # static batching: wait for the whole batch to end
            batch: List[Request] = []
            reserved = 0
            while self.queue and len(batch) < len(free):
                req = self.queue[0]
                if req.prompt_len > self.max_len - 1:
                    self.queue.popleft()
                    req._finish(RequestState.FAILED,
                                f"prompt ({req.prompt_len} tokens) does not "
                                f"fit max_len={self.max_len}")
                    self._stats["failed"] += 1
                    continue
                if self.paged:
                    # reserve the prompt's pages plus one decode-growth
                    # page (capped at what the sequence can ever address)
                    need = min(-(-req.prompt_len // self.page_size) + 1,
                               self.max_pages)
                    if need > self.num_pages:
                        # no recycling can ever serve it: fail now rather
                        # than livelock the FIFO queue behind it
                        self.queue.popleft()
                        req._finish(
                            RequestState.FAILED,
                            f"prompt needs {need} pages of {self.page_size} "
                            f"but the pool only has {self.num_pages}")
                        self._stats["failed"] += 1
                        continue
                    if reserved + need > len(self.free_pages):
                        break  # transient shortage: FIFO backpressure
                    reserved += need
                batch.append(self.queue.popleft())
        if not batch:
            return 0
        now = time.time()
        for j, req in enumerate(batch):
            i = free[j]
            if self.paged and not self._alloc_pages(
                    i, -(-req.prompt_len // self.page_size)):
                raise RuntimeError("page reservation failed after admission check")
            self.slots[i] = req
            self.lengths[i] = 0  # becomes prompt_len when prefill finishes
            self.prefill_pos[i] = 0
            self.slot_prompt[i] = np.asarray(req.prompt, np.int32)
            self.slot_keys[i] = make_slot_key(req.seed)
            self.slot_temp[i] = req.temperature
            self.slot_topk[i] = req.top_k
            req.state = RequestState.RUNNING
            req.admitted_at = now
        with self._lock:
            self._stats["admitted"] += len(batch)
            self._stats["prefill_batches"] += 1
        return len(batch)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_step(self) -> bool:
        """Spend up to ``prefill_chunk_tokens`` prompt tokens across the
        prefilling slots in ONE ragged chunk forward (rows not taking
        tokens ride with ``chunk_lens == 0``).  Rows whose prompt completes
        take their first token here and move on to decode."""
        taking: Dict[int, int] = {}
        budget = (self.prefill_chunk_tokens if self.prefill_chunk_tokens
                  is not None else self.max_len)
        used = 0
        for i, req in enumerate(self.slots):
            if req is None or self.prefill_pos[i] < 0 or used >= budget:
                continue
            take = min(req.prompt_len - int(self.prefill_pos[i]), budget - used)
            if take > 0:
                taking[i] = take
                used += take
        if not taking:
            return False
        T = _bucket(max(taking.values()))
        tokens = np.zeros((self.max_slots, T), np.int32)
        base = np.zeros(self.max_slots, np.int32)
        clens = np.zeros(self.max_slots, np.int32)
        for i, take in taking.items():
            pos = int(self.prefill_pos[i])
            tokens[i, :take] = self.slot_prompt[i][pos:pos + take]
            base[i] = pos
            clens[i] = take
        if self.paged:
            # bucket the table to the prefilling rows' own page frontier
            need = max(-(-(int(base[i]) + take) // self.page_size)
                       for i, take in taking.items())
            mb = min(_bucket(need, lo=1), self.max_pages)
            self._count_retrace("prefill", (T, mb))
            bt = self._tensor(self.block_table[:, :mb])
        else:
            self._count_retrace("prefill", (T,))
            bt = None
        next_tok, _, self.cache = self._prefill_chunk(
            self._run_params, self._tensor(tokens), self._tensor(base),
            self._tensor(clens), self.cache, bt)
        done = [i for i, take in taking.items()
                if int(self.prefill_pos[i]) + take >= self.slots[i].prompt_len]
        for i, take in taking.items():
            self.prefill_pos[i] += take
        if done:
            toks = next_tok.cpu().numpy()
            now = time.time()
            for i in done:
                req = self.slots[i]
                self.lengths[i] = req.prompt_len
                self.prefill_pos[i] = -1
                self.slot_prompt[i] = None
                req.first_token_at = now
                tok = int(toks[i])
                req.tokens.append(tok)
                req.token_times.append(now)
                self.last_tok[i] = tok
                if self._should_stop(req, tok, int(self.lengths[i])):
                    self._finish_slot(i, RequestState.DONE)
        with self._lock:
            self._stats["prefill_chunks"] += 1
            self._stats["prefill_tokens"] += used
        return True

    def step(self) -> bool:
        """Admit what fits, spend one bounded prefill chunk, then run one
        fused decode over every slot whose prefill already finished.
        Returns False when there was nothing to do."""
        progressed = self._admit() > 0
        progressed = self._prefill_step() or progressed
        if self.paged:
            self._ensure_decode_pages()
        active = np.array([r is not None and self.prefill_pos[i] < 0
                           for i, r in enumerate(self.slots)])
        if not active.any():
            return progressed
        if self.paged:
            # bucket the block table (and with it the kernel grid) to the
            # pages actually in use
            mb = min(_bucket(max(len(p) for p in self.slot_pages), lo=1),
                     self.max_pages)
            self._count_retrace("decode", (mb, False))
            # rows that must not decode (free or mid-prefill) see an
            # all-sentinel table, so their junk appends drop
            bt_step = self.block_table[:, :mb].copy()
            bt_step[~active] = self.num_pages
            lengths, bt = self.lengths, self._tensor(bt_step)
        else:
            self._count_retrace("decode", (self.max_len, False))
            # rows that must not decode (free, or mid-prefill with the
            # prompt already at position 0 on) get length -1: their append
            # drops, so their rows stay bitwise intact, and they attend
            # nothing, so the kernel reads none of their cache
            lengths, bt = np.where(active, self.lengths, -1), None
        greedy, _, self.cache = self._decode(
            self._run_params, self._tensor(self.last_tok)[:, None], self.cache,
            self._tensor(lengths.astype(np.int32)), bt)
        toks = np.where(active, greedy.cpu().numpy(), 0)
        self.lengths = self.lengths + active.astype(np.int32)
        # paged holds only its allocated pages, contiguous always holds
        # the full [max_slots, max_len] rows
        bytes_now = (self.pages_in_use() * self._page_bytes if self.paged
                     else self._cache_bytes)
        with self._lock:
            self._stats["decode_steps"] += 1
            self._stats["decode_slot_steps"] += int(active.sum())
            self._stats["kv_bytes_step_sum"] += bytes_now
            self._stats["kv_tokens_step_sum"] += int(self.lengths[active].sum())
        generated = 0
        now = time.time()
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            tok = int(toks[i])
            req.tokens.append(tok)
            req.token_times.append(now)
            self.last_tok[i] = tok
            generated += 1
            if self._should_stop(req, tok, int(self.lengths[i])):
                self._finish_slot(i, RequestState.DONE)
        if generated:
            self._bump("tokens_generated", generated)
        return True

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        """Synchronous drive: step until queue and slots are empty."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def run_service(self, *args, **kwargs):
        raise NotImplementedError(
            "run_service needs the runtime's ServiceControl, a later slice "
            "(ROADMAP.md queue 1, item 11)")

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            now = time.time()
            queued = len(self.queue)
            oldest = (now - min(r.submitted_at for r in self.queue)
                      if self.queue else 0.0)
            free_pages = len(self.free_pages) if self.paged else 0
            occupied = sum(r is not None for r in self.slots)
            prefill_widths = {key[0] for key in self._seen_shapes["prefill"]}
        in_use = self.num_pages - free_pages
        out.update({
            "engine": self.uid,
            "max_slots": self.max_slots,
            "max_len": self.max_len,
            "continuous": self.continuous,
            "prefill_only": False,
            "kv_layout": "paged" if self.paged else "contiguous",
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            # chunk-width buckets seen (the JAX engine keeps one jitted
            # step per bucket; the port runs eagerly)
            "prefill_fns_cached": len(prefill_widths),
            "queued": queued,
            "queue_depth": queued,
            "oldest_queued_age_s": oldest,
            "occupied": occupied,
            "kv_cache_bytes": (in_use * self._page_bytes if self.paged
                               else self._cache_bytes),
            "kv_cache_capacity_bytes": (self.num_pages * self._page_bytes
                                        if self.paged else self._cache_bytes),
        })
        if self.paged:
            out.setdefault("peak_pages", 0)
            out.update({
                "page_size": self.page_size,
                "num_pages": self.num_pages,
                "pages_in_use": in_use,
                "free_pages": free_pages,
                "kv_cache_peak_bytes": (out.get("peak_pages", 0)
                                        * self._page_bytes),
            })
        out.setdefault("retraces", 0)
        d = out.get("decode_steps", 0)
        out["slot_occupancy"] = (
            out.get("decode_slot_steps", 0) / (d * self.max_slots) if d else 0.0)
        # mean cache bytes held per live token across decode steps
        out["kv_bytes_per_token"] = (
            out.get("kv_bytes_step_sum", 0)
            / max(out.get("kv_tokens_step_sum", 0), 1))
        return out
