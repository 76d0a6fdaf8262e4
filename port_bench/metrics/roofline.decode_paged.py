"""Kernel 3's share of its roofline in the traced window: the least time
the window's paged decode calls could take (their bytes, or FLOPs where
those bound, from ``arith.kernels``, counted from the contexts each step
decoded) over the profiler's device time of the kernel's functions."""
from port_bench.arith import kernels
from port_bench.harness import serve_read as R


def read(ctx):
    steps = R.traced_steps(ctx)
    if not steps:
        return None
    f, b = R.decode_work(ctx, steps)
    t = R.kernel_s(ctx, R.DECODE_PAGED)
    if f == 0 or t == 0:
        return None
    return 100.0 * kernels.bound_s(f, b) / t
