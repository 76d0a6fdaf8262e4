"""Kernel 5's share of its roofline in the traced window: the least time
the window's paged prefill calls could take (FLOPs or bytes, whichever
bounds, from ``arith.kernels``, counted from each chunk's rows) over the
profiler's device time of the kernel's functions (the scatter that
writes the chunk's K/V is a kernel of its own, not counted)."""
from port_bench.arith import kernels
from port_bench.harness import serve_read as R


def read(ctx):
    steps = R.traced_steps(ctx)
    if not steps:
        return None
    f, b = R.prefill_work(ctx, steps)
    t = R.kernel_s(ctx, R.PREFILL_PAGED)
    if f == 0 or t == 0:
        return None
    return 100.0 * kernels.bound_s(f, b) / t
