"""Operations and bytes of the serving attention kernels, counted from
what their inputs need (each input byte read once, each output byte
written once), whatever implements them.

Kernel 3, the paged decode (``decode_attention_paged.cu``): one call a
layer a decode step; a live row with context ``n`` (positions it attends,
its new token included) reads ``n`` positions of K and V and its query,
and writes its output.  Kernel 5, the paged prefill
(``prefill_attention_paged.cu``): one call a layer a chunk; a row that
takes ``t`` tokens at offset ``p`` attends causally over ``p + t``
positions.  The chunk's own K/V are written by the scatter, a kernel of
its own that is not counted here.  Block-table reads (4 bytes a page) are
counted with the pages a row addresses.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from port_bench.arith.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

PAGE = 16


def _pages(n: int, page: int = PAGE) -> int:
    return -(-n // page)


def decode_paged(H: int, KV: int, D: int, contexts: Iterable[int], esize: int = 2,
                 page: int = PAGE) -> Tuple[float, float]:
    """(FLOPs, bytes) of one paged decode call over rows of the given
    contexts."""
    flops = byts = 0
    for n in contexts:
        flops += 4 * H * D * n
        byts += 2 * n * KV * D * esize + 2 * H * D * esize + 4 * _pages(n, page)
    return float(flops), float(byts)


def prefill_paged(H: int, KV: int, D: int, rows: Iterable[Tuple[int, int]],
                  esize: int = 2, page: int = PAGE) -> Tuple[float, float]:
    """(FLOPs, bytes) of one paged prefill call; ``rows`` are the (offset
    ``p``, tokens ``t``) of the rows that take tokens."""
    flops = byts = 0
    for p, t in rows:
        flops += 4 * H * D * (t * p + t * (t + 1) // 2)
        byts += 2 * (p + t) * KV * D * esize + 2 * t * H * D * esize + 4 * _pages(p + t, page)
    return float(flops), float(byts)


def bound_s(flops: float, byts: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS_PER_S, byts / HBM_BYTES_PER_S)
