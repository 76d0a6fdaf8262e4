"""What the serving cells' per-layer readers share: the steps that lie in
the traced window, and the kernels' device time there."""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from port_bench.arith import kernels

# kernel 3 (paged decode) and kernel 5 (paged prefill), by their CUDA
# function names; the contiguous kernels' names begin with ``contig_``
DECODE_PAGED = re.compile(r"(?<!contig_)(paged_decode_mma_kernel|decode_split_kernel|decode_combine_kernel)")
PREFILL_PAGED = re.compile(r"(?<!contig_)(prefill_paged_wgmma_kernel|prefill_kernel)")


def traced_steps(ctx: Dict) -> Optional[List[Dict]]:
    if "trace" not in ctx:
        return None
    p0, p1 = ctx["p0"], ctx["p1"]
    return [s for s in ctx["steps"] if s["t0"] >= p0 and s["t1"] <= p1]


def kernel_s(ctx: Dict, pattern) -> float:
    return sum(v for n, v in ctx["trace"].time_by_name().items() if pattern.search(n))


def kernel_heads(ctx: Dict):
    m = ctx["dims"]
    return m["num_heads"], m["num_kv_heads"], m["head_dim"]


def decode_work(ctx: Dict, steps: List[Dict]):
    H, KV, D = kernel_heads(ctx)
    L = ctx["dims"]["num_layers"]
    f = b = 0.0
    for s in steps:
        if s["decode"]:
            ff, bb = kernels.decode_paged(H, KV, D, s["decode"], page=ctx["page"])
            f, b = f + L * ff, b + L * bb
    return f, b


def prefill_work(ctx: Dict, steps: List[Dict]):
    H, KV, D = kernel_heads(ctx)
    L = ctx["dims"]["num_layers"]
    f = b = 0.0
    for s in steps:
        if s["prefill"]:
            ff, bb = kernels.prefill_paged(H, KV, D, [(off, take) for _, off, take, _ in s["prefill"]],
                                           page=ctx["page"])
            f, b = f + L * ff, b + L * bb
    return f, b
