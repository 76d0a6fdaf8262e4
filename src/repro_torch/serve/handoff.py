"""KV handoff: migrating a prefilled request between paged engines (mirror
of ``repro.serve.handoff``).

Prefill/decode disaggregation ships a finished prompt from a
prefill-only :class:`~repro_torch.serve.engine.ServeEngine` to a decode
engine.  Both engines keep their KV in a page pool addressed by per-slot
block tables, so the migration is a **block copy + block-table rewrite**,
never a cache copy: the exporter gathers exactly the pages its
block-table row points at (``ceil(prompt_len / page_size)`` of them) and
copies them to the host, and the importer scatters them into freshly
allocated pages of its own pool and writes a new block-table row.  The
bytes that move are bounded by the pages the *request* owns; the pool
itself never moves.

A :class:`KVHandoff` rides the normal engine queue: the router delivers
it through a :class:`~repro_torch.core.transport.Transport` into the
decode engine's ``submit``, and the decode engine's own thread performs
the import inside ``_admit`` (all cache mutation stays on the engine
thread).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.common.params import from_jax_params, to_numpy
from repro_torch.core.resilience import faults as _faults
from repro_torch.serve.request import Request


def maybe_fail_delivery(hand: "KVHandoff") -> None:
    """Chaos hook (``FaultPlan.fail_handoff``): the router consults this
    at the moment a migrated prefill is submitted to its decode target.  A
    fired fault raises :class:`~repro_torch.core.resilience.faults.InjectedFault`
    and the router re-queues the handoff for another route; the page
    blocks are intact on the host, so the request is re-routed, never
    lost."""
    inj = _faults.active()
    if inj is None:
        return
    act = inj.fire("handoff.deliver", rid=hand.rid, source=hand.source)
    if act is not None and act.get("action") == "fail":
        raise _faults.InjectedFault(
            f"injected handoff-delivery failure ({hand.rid})")


@dataclasses.dataclass
class KVHandoff:
    """A prefilled request plus the page blocks backing its KV.

    ``pages`` mirrors the engine cache tree (``head_layers`` / ``unit`` /
    ``tail_layers``) with every pool leaf reduced to the request's own
    pages, as host tensors: ``[n_pages, page_size, ...]`` for per-layer
    leaves, ``[layers, n_pages, page_size, ...]`` for the stacked unit.
    Page *order* is the block-table row order, so intra-page offsets
    survive the move: a prompt whose tail ends inside a partly filled page
    keeps decoding into that page on the importing side.
    """

    request: Request
    length: int                 # tokens already written into the pages
    last_tok: int               # the first generated token (feeds decode)
    slot_key: np.ndarray        # [2] uint32 sampling key, post-advance
    temperature: float
    top_k: int
    pages: Any                  # cache-shaped tree of gathered page blocks
    n_pages: int
    page_size: int
    kv_bytes: int               # total bytes in ``pages`` (transport cost)
    source: str = ""            # exporting engine's uid (stats/debugging)

    @property
    def rid(self) -> str:
        return self.request.rid

    # -- wire serialization -------------------------------------------------
    # Pickling lowers every page leaf to numpy (bf16, which numpy lacks,
    # as fp32: exact), as the JAX package's handoff does, so a handoff of
    # either package is a plain state a process can rebuild; unpickling
    # turns the pages back into host tensors.

    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state["pages"] = to_numpy(self.pages)
        state["slot_key"] = np.asarray(self.slot_key)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """The far side of a pickle: the pages back as host tensors."""
        self.__dict__.update(KVHandoff.from_state(state).__dict__)

    @classmethod
    def from_state(cls, state: Dict[str, Any], device="cpu") -> "KVHandoff":
        """A handoff from a numpy state (``__getstate__`` of a handoff of
        this package or of the JAX package): the page blocks become
        tensors on ``device`` through ``common.params.from_jax_params``;
        the importing engine casts them to its pool's dtype."""
        state = dict(state)
        state["pages"] = from_jax_params(state["pages"], device)
        state["slot_key"] = np.asarray(state["slot_key"], np.uint32)
        return cls(**state)
