"""p95 over the window's requests of the wait from when each was due to
its admission into a slot (``Request.admitted_at``)."""
from port_bench.harness.common import percentile


def read(ctx):
    if ctx.get("kind", "serve") != "serve":
        return None
    waits = [(t.req.admitted_at - t.due) * 1e3 for t in ctx["tracked"]
             if t.in_window and t.req.admitted_at is not None]
    return percentile(waits, 95) if waits else None
