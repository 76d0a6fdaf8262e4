"""Continuous-batching serving on the paged KV cache (mirror of
``repro.serve``, direct-mode ServeEngine with greedy decoding)."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request, RequestState

__all__ = ["ServeEngine", "Request", "RequestState"]
