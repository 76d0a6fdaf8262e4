"""Continuous-batching serving on the paged or contiguous KV cache
(mirror of ``repro.serve``: the direct-mode ServeEngine, greedy or
seeded sampling)."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request, RequestState

__all__ = ["ServeEngine", "Request", "RequestState"]
