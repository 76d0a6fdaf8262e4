"""Continuous-batching serving on the paged or contiguous KV cache
(mirror of ``repro.serve``): the ServeEngine (greedy or seeded sampling,
a service stage of the runtime) and its fleet — ``EngineRouter`` (+
``build_fleet``), a shared, load-aware request queue over N engines with
rolling restarts, circuit breakers and prefill/decode disaggregation, in
which finished prompts migrate between engines as ``KVHandoff`` page
blocks through the Transport."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.handoff import KVHandoff
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.router import EngineRouter, build_fleet

__all__ = ["ServeEngine", "Request", "RequestState", "KVHandoff",
           "EngineRouter", "build_fleet"]
