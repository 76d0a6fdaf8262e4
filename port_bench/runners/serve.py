"""The serving runner: one ``ServeEngine`` of the port on one card, fed
by an open loop.

Set-up builds the model's weights on the card from the seed, the engine
with the cell's settings, and warms it with a fixed set of requests that
runs every chunk width and block-table width the cell's traffic can give
(the same for every seed).  Then requests arrive on the traffic's
schedule: a ramp, the measured window of ``--seconds``, and arrivals
after it until every request due in the window has its first token (at
most ``wait_after_s``).  The loop submits what is due, calls
``engine.step()`` while there is work and sleeps until the next arrival
otherwise.  Around each call it records a span and what the step did,
read from the requests and from the engine's slot table between calls:
which requests took how many prompt tokens at which offset, and which
decoded at which context.

Metrics: tokens whose emission time lies in the window over its
seconds; TTFT from the time each window request was due; the gaps
between consecutive tokens that both lie in the window.  Then, with the
engine's cache freed, the reference recomputes a sample of finished
requests (drawn from the seed, the longest among them) and the gap by
which a served token's logit lies below the reference's best (the
cell's statistic of it) decides ``correct``.  A control run puts the
lower-precision control's tokens in the served tokens' place and judges
them by the same checks.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.harness import common, traffic as traffic_gen, weights
from port_bench.harness.trace import DeviceTrace
from port_bench.reference.lm import Ref, Seq, gaps

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(config: Dict) -> Dict:
    """The model's sizes as the configuration file states them: what the
    reference and the FLOP counts use."""
    d, H = config["hidden_size"], config["num_attention_heads"]
    m = {"d_model": d, "num_heads": H, "num_kv_heads": config["num_key_value_heads"],
         "head_dim": d // H, "d_ff": config["intermediate_size"],
         "num_layers": config["num_hidden_layers"], "vocab_size": config["vocab_size"],
         "rope_theta": config["rope_theta"], "norm_eps": config["rms_norm_eps"]}
    if config.get("num_local_experts"):
        # Arctic's residual MLP is hidden_size wide (``ArcticMLP(is_residual_mlp=True)``)
        m.update(num_experts=config["num_local_experts"], top_k=config["num_experts_per_tok"],
                 capacity_factor=config["routing"]["capacity_factor"],
                 min_capacity=config["routing"]["min_capacity"],
                 dense_ff=d if config.get("use_residual") else 0)
    return m


def program_config(config: Dict):
    """The port's configuration of the model, with the file's overrides,
    held to the file's published numbers."""
    from repro_torch.configs import get_config

    prog = config["program"]
    ov = {k: DTYPES.get(v, v) if isinstance(v, str) else v
          for k, v in prog.get("overrides", {}).items()}
    cfg = get_config(prog["arch"]).with_overrides(**ov)
    wrong = {k: (config[k], getattr(cfg, f)) for k, f in config["map"].items()
             if getattr(cfg, f) != config[k]}
    m = dims(config)
    if cfg.head_dim != m["head_dim"]:
        wrong["head_dim"] = (m["head_dim"], cfg.head_dim)
    if m.get("dense_ff") and cfg.dense_ff != m["dense_ff"]:
        wrong["dense_ff"] = (m["dense_ff"], cfg.dense_ff)
    if wrong:
        raise common.BenchError(f"the port's {prog['arch']} departs from the file: {wrong}")
    return cfg


def bucket(n: int, lo: int = 2) -> int:
    """The engine's chunk width for a step whose widest row takes ``n``
    tokens: the next power of two, at least ``lo`` (the engine's stated
    shape rule, which the reference's routing groups follow)."""
    p = lo
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class Tracked:
    idx: int
    req: object
    due: float            # time.time() at which it was due
    prompt_len: int
    pos: int = 0          # prompt tokens written so far
    ntok: int = 0
    chunks: List = dataclasses.field(default_factory=list)   # (offset, take, T)
    in_window: bool = False


def warmup_requests(max_len: int, chunk: int) -> List[tuple]:
    """(prompt length, tokens) pairs that run every chunk width up to
    ``chunk`` and every block-table width up to ``max_len``'s, one at a
    time."""
    lens, n = [], 1
    while n <= chunk:
        lens.append(n)
        n *= 2
    p = 32
    while p < max_len:
        lens.append(min(p - 1, max_len - 3))
        p *= 2
    return [(L, 2) for L in lens]


def run(opts) -> Dict:
    cell, config, mix = opts.cell, opts.config, opts.traffic
    dev = torch.device(opts.device)
    if opts.model is not None:          # a test's own model: (port config, sizes)
        cfg, m = opts.model
    else:
        cfg, m = program_config(config), dims(config)
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.request import Request, RequestState
    from repro_torch.train.state import model_specs

    eng_kw = cell["engine"]
    Hp, KVp = cfg.padded_gqa()
    W = weights.make(model_specs(cfg), opts.seed, dev, cfg.compute_dtype,
                     std=config.get("initializer_range", 0.02),
                     live_heads=m["num_heads"] if Hp != m["num_heads"] else 0,
                     kv_heads=m["num_kv_heads"])
    engine = ServeEngine(cfg, params=W, device=dev, seed=opts.seed, kv_layout="paged",
                         max_slots=eng_kw["max_slots"], max_len=eng_kw["max_len"],
                         page_size=eng_kw["page_size"],
                         prefill_chunk_tokens=eng_kw["prefill_chunk_tokens"])
    if opts.fault is not None:
        opts.fault(engine)
    wrng = np.random.default_rng(0)
    for L, g in warmup_requests(eng_kw["max_len"], eng_kw["prefill_chunk_tokens"]):
        engine.submit(Request(wrng.integers(0, m["vocab_size"], L).astype(np.int32),
                              max_new_tokens=g))
        engine.run_until_drained()
    tracer = DeviceTrace(torch) if opts.trace else None
    if tracer is not None:
        # the profiler's first start sets up CUPTI, which takes seconds
        tracer.start()
        engine.submit(Request(wrng.integers(0, m["vocab_size"], 8).astype(np.int32),
                              max_new_tokens=2))
        engine.run_until_drained()
        tracer.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    vocab = m["vocab_size"]
    W_s = float(opts.seconds)
    arrivals = traffic_gen.schedule(mix, cell["rate_per_s"], W_s, opts.seed, vocab)
    trace_s = min(float(cell.get("trace_s", 10.0)), W_s)
    t_ramp = time.time()
    setup_s = t_ramp - opts.t_start
    w0 = t_ramp + float(mix["ramp_s"])
    w1 = w0 + W_s
    p_start = w0 + (W_s - trace_s) / 2
    deadline = w1 + float(mix["wait_after_s"])

    tracked: List[Tracked] = []
    active: List[Tracked] = []
    steps: List[Dict] = []
    spans: List[tuple] = []
    nxt = traced = 0                     # traced: 0 before the trace, 1 in it, 2 after
    zeroed, stats_at_w1 = False, None
    while True:
        now = time.time()
        if not zeroed and now >= w0:
            engine.reset_stats()
            zeroed = True
        if stats_at_w1 is None and now >= w1:
            stats_at_w1 = engine.stats()
        if tracer is not None and traced == 0 and now >= p_start:
            tracer.start()
            traced = 1
        if traced == 1 and now >= p_start + trace_s:
            tracer.stop()
            traced = 2
        while nxt < len(arrivals) and w0 + arrivals[nxt].t <= now:
            a = arrivals[nxt]
            due = w0 + a.t
            r = engine.submit(Request(a.prompt, max_new_tokens=a.max_new,
                                      temperature=float(mix.get("temperature", 0.0))))
            t = Tracked(nxt, r, due, a.prompt.shape[0], in_window=w0 <= due < w1)
            tracked.append(t)
            active.append(t)
            nxt += 1
        if now >= w1:
            pending = [t for t in tracked if t.in_window and not t.req.tokens
                       and t.req.state is not RequestState.FAILED]
            if not pending or now >= deadline:
                break
        if engine.has_work():
            s0 = time.time()
            engine.step()
            s1 = time.time()
            spans.append(("engine.step", s0, s1))
            steps.append(record_step(engine, active, s0, s1))
            active = [t for t in active if not t.req.done()]
        else:
            wake = w0 + arrivals[nxt].t if nxt < len(arrivals) else now + 0.01
            time.sleep(min(max(wake - time.time(), 0.0), 0.01))
    if traced == 1:
        tracer.stop()
    if stats_at_w1 is None:
        stats_at_w1 = engine.stats()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0

    # -- end-to-end metrics ---------------------------------------------------------
    window = [t for t in tracked if t.in_window]
    failed = [t for t in window if t.req.state is RequestState.FAILED or not t.req.tokens]
    ttft = [(t.req.first_token_at - t.due) * 1e3 for t in window if t.req.first_token_at]
    ttft += [(deadline - t.due) * 1e3 for t in failed]
    n_out = sum(sum(1 for x in t.req.token_times if w0 <= x < w1) for t in tracked)
    itl = [(b - a) * 1e3 for t in tracked
           for a, b in zip(t.req.token_times, t.req.token_times[1:]) if w0 <= a and b < w1]
    queued_at_w1 = sum(1 for t in tracked if t.due < w1 and not (
        t.req.admitted_at and t.req.admitted_at <= w1))
    e2e = {"output_tokens_per_s": n_out / W_s,
           "ttft_p95_ms": common.percentile(ttft, 95),
           "itl_p95_ms": common.percentile(itl, 95),
           "setup_s": setup_s}

    # -- correctness: the reference over a sample of finished requests -----------------
    done = [t for t in tracked if t.req.state is RequestState.DONE]
    short = [t.idx for t in done if len(t.req.tokens) != t.req.max_new_tokens]
    sample = pick_sample(done, opts.seed, mix)
    engine.cache = None
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    seqs = [Seq(list(map(int, t.req.prompt)) + t.req.tokens[:-1], t.prompt_len,
                t.chunks if m.get("num_experts") else None) for t in sample]
    ref = Ref(W, m)
    ref_logits = ref.served_logits(seqs)
    per_seq = [gaps(lg, t.req.tokens) for lg, t in zip(ref_logits, sample)]
    served = judged = gap_stats(per_seq)
    ref_s = time.time() - t_ref
    control = margins = None
    if ref.margins:
        margins = margin_look(per_seq, seqs, ref.margins)
    if opts.control:
        # the control's answer in the program's place: at each position of the
        # same prompts and served tokens, the token the lower precision puts first
        ctrl = Ref(W, m, fp8=True).served_logits(seqs)
        control = judged = gap_stats([gaps(lg, c.argmax(-1).tolist())
                                      for lg, c in zip(ref_logits, ctrl)])
    (stat, limit), = cell["limits"].items()
    worst = judged[stat.replace("logit_gap_", "")]
    checks = {stat: {"value": worst, "limit": float(limit)},
              "failed_requests": {"value": len(failed), "limit": 0},
              "short_outputs": {"value": len(short), "limit": 0},
              "sampled_tokens": {"value": sum(len(t.req.tokens) for t in sample),
                                 "limit": int(mix["sample_served_tokens"])}}
    correct = (worst <= limit and not failed and not short
               and checks["sampled_tokens"]["value"] >= min(
                   checks["sampled_tokens"]["limit"],
                   sum(len(t.req.tokens) for t in done)))
    out = {"correct": bool(correct), "attempted": len(window), "failed": len(failed),
           "e2e": e2e, "checks": checks, "peak": peak,
           "info": {"ref_s": ref_s, "served_gaps": served, "control_gaps": control,
                    "margins": margins, "sample": [t.idx for t in sample], "steps": len(steps),
                    "requests": len(tracked), "window_requests": len(window),
                    "queued_at_w1": queued_at_w1, "e2e": e2e}}
    ctx = {"kind": "serve", "w0": w0, "w1": w1, "steps": steps, "tracked": tracked, "dims": m,
           "max_slots": eng_kw["max_slots"], "stats": stats_at_w1, "page": eng_kw["page_size"]}
    if traced:
        ctx.update(trace=tracer, p0=tracer.t0_ns / 1e9, p1=tracer.t1_ns / 1e9)
        out["busy_s"] = tracer.busy_s()
        out["window_s"] = tracer.window_s
        out["breakdown"] = tracer.breakdown(spans)
        out["info"]["trace"] = tracer.diagnostics()
    out["ctx"] = ctx
    return out


def record_step(engine, active: List[Tracked], s0: float, s1: float) -> Dict:
    """What one ``step()`` did, from the requests and the engine's slot
    table after it: prompt rows (request, offset, tokens), the chunk width,
    and the context of every decoded token."""
    slot_of = {id(r): i for i, r in enumerate(engine.slots) if r is not None}
    rows, dec = [], []
    for t in active:
        r = t.req
        nt = len(r.tokens)
        i = slot_of.get(id(r))
        if i is not None and engine.prefill_pos[i] >= 0:
            pos = int(engine.prefill_pos[i])
        elif nt > 0:
            pos = t.prompt_len
        else:
            pos = t.pos
        if pos > t.pos:
            rows.append((t, t.pos, pos - t.pos))
        first = 1 if (t.ntok == 0 and nt > 0) else 0
        for j in range(t.ntok + first, nt):
            dec.append(t.prompt_len + j)
        t.pos, t.ntok = pos, nt
    T = bucket(max(take for _, _, take in rows)) if rows else 0
    for t, off, take in rows:
        t.chunks.append((off, take, T))
    return {"t0": s0, "t1": s1, "T": T,
            "prefill": [(t.idx, off, take, off + take == t.prompt_len) for t, off, take in rows],
            "decode": dec}


def margin_look(per_seq, seqs, margins: Dict) -> Dict:
    """The routing margins (last chosen expert's probability less the
    next one's, least over the layers) of the decoded positions whose
    served token lies farthest below the reference's best, beside the
    median margin of all of them."""
    rows = []
    for i, (g, s) in enumerate(zip(per_seq, seqs)):
        for j in range(1, g.numel()):
            key = (i, s.prompt_len + j - 1)
            if key in margins:
                rows.append((float(g[j]), margins[key]))
    if not rows:
        return {}
    rows.sort(key=lambda r: -r[0])
    return {"top_gaps_margins": [[round(a, 4), b] for a, b in rows[:8]],
            "median_margin": float(np.median([b for _, b in rows])),
            "share_margin_under_1e-3": float(np.mean([b < 1e-3 for _, b in rows]))}


def gap_stats(per_seq: List[torch.Tensor]) -> Dict:
    """The widest gap, its 99th and 90th percentiles, the mean, and the
    share of tokens that are not the reference's best."""
    g = torch.cat(per_seq).double().cpu() if per_seq else torch.zeros(1, dtype=torch.float64)
    return {"max": float(g.max()), "p99": float(torch.quantile(g, 0.99)),
            "p90": float(torch.quantile(g, 0.90)), "mean": float(g.mean()),
            "not_best": float((g > 0).double().mean()), "tokens": int(g.numel())}


def pick_sample(done: List[Tracked], seed: int, mix: Dict) -> List[Tracked]:
    """Finished requests for the reference: the longest, then others in
    an order drawn from the seed, until ``sample_served_tokens`` tokens or
    ``sample_max_requests`` requests."""
    if not done:
        return []
    longest = max(done, key=lambda t: (t.prompt_len + len(t.req.tokens), -t.idx))
    rest = [t for t in done if t is not longest]
    order = np.random.default_rng([seed, 2]).permutation(len(rest))
    picked, n = [longest], len(longest.req.tokens)
    for k in order:
        if n >= mix["sample_served_tokens"] or len(picked) >= mix["sample_max_requests"]:
            break
        picked.append(rest[k])
        n += len(rest[k].req.tokens)
    return picked
