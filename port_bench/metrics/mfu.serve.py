"""The whole step's share of the card's bf16 peak in the traced window:
model FLOPs of the prompt tokens and served tokens the window's steps
processed (``arith.flops``: no padding, no padded heads, top-k experts
only) over the window's seconds times 989 TFLOP/s."""
from port_bench.arith import flops
from port_bench.arith.peaks import BF16_FLOPS_PER_S
from port_bench.harness import serve_read as R


def read(ctx):
    steps = R.traced_steps(ctx)
    if not steps:
        return None
    m = ctx["dims"]
    f = 0.0
    for s in steps:
        for _, off, take, last in s["prefill"]:
            f += flops.tokens_flops(m, off, take, 1 if last else 0)
        for n in s["decode"]:
            f += flops.tokens_flops(m, n - 1, 1, 1)
    if f == 0:
        return None
    return 100.0 * f / (ctx["trace"].window_s * BF16_FLOPS_PER_S)
