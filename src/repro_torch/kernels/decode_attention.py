"""Split-K decode attention: the CUDA kernels' wrappers and their plain
PyTorch versions (mirror of ``repro.kernels.decode_attention``).

One query token per row attends the row's live prefix ``[0, cache_len)``.
Two layouts, as in JAX:

* ``decode_attention``: the row's own contiguous cache ``[B, S, KV, D]``;
  ``cache_len`` is a scalar or ``[B]`` and a static ``window`` > 0 also
  masks positions before ``cache_len - window``
  (``csrc/decode_attention.cu``);
* ``decode_attention_paged``: the shared page pool ``[num_pages,
  page_size, KV, D]`` read through the row's block table
  (``csrc/decode_attention_paged.cu``).

Each kernel reduces spans of positions into fp32 ``(m, l, acc)``
partials; a combine pass in the same library merges them into ``[B, H,
D]`` in q's dtype.  Rows with nothing live (``cache_len == 0``) return
zeros.

The dispatchers take the plain version for CPU tensors and launch the
kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# the plain versions of the kernels: fp32 softmax over the masked row
# (gathered through the clamped table, when paged), zeros for empty rows
decode_attention_plain = _ref.decode_attention_ref
decode_attention_paged_plain = _ref.decode_attention_paged_ref

# enough (row, KV head, span) blocks to cover the card's 132 SMs twice
_TARGET_BLOCKS = 264
# cache positions the contiguous kernel stages per step (kTile in the .cu)
_TILE = 32


def _splits(B: int, KV: int) -> int:
    """Splits per (row, KV head) that leave about ``_TARGET_BLOCKS``
    blocks in the grid, so short batches split finer."""
    return max(1, -(-_TARGET_BLOCKS // max(1, B * KV)))


def split_span(B: int, KV: int, max_pages: int) -> int:
    """Logical pages per split-K block of the paged kernel."""
    return max(1, -(-max_pages // _splits(B, KV)))


def contiguous_split_span(B: int, KV: int, S: int) -> int:
    """Cache positions per split-K block of the contiguous kernel, in
    whole tiles."""
    span = -(-S // _splits(B, KV))
    return -(-span // _TILE) * _TILE


def _rows_i32(cache_len, B, device) -> torch.Tensor:
    """Scalar or [B] lengths -> contiguous [B] int32 on ``device``."""
    return _ref.as_rows(cache_len, B, device).to(torch.int32).contiguous()


def _check(q, k, v, cache_len):
    """Checks both kernels share; ``k``, ``v`` are the caches or pools."""
    B, H, D = q.shape
    KV, Dk = k.shape[2], k.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"decode kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("cache_len", cache_len)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in build.KERNEL_DTYPES:
        raise ValueError(f"decode kernel takes fp32/bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("caches must have q's dtype")
    if D not in build.HEAD_DIMS or Dk != D or v.shape != k.shape:
        raise ValueError(f"head dim {D} (caches {tuple(k.shape)}) not in "
                         f"{build.HEAD_DIMS}")
    if H % KV or cache_len.shape != (B,):
        raise ValueError("shape mismatch: q [B,H,D], cache_len [B], "
                         "H % KV == 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention_kernel(q, k, v, cache_len, *, window: int = 0) -> torch.Tensor:
    """Launch the contiguous CUDA kernel (CUDA tensors only, raises
    otherwise)."""
    B, H, D = q.shape
    cache_len = _rows_i32(cache_len, B, q.device)
    _check(q, k, v, cache_len)
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if k.shape[0] != B or G > 32 or S < 1 or window < 0:
        raise ValueError("caches must be [B, S>=1, KV, D] with H/KV <= 32 "
                         "and window >= 0")
    span = contiguous_split_span(B, KV, S)
    nsplit = -(-S // span)
    m_p = torch.empty((B * KV, nsplit, G), dtype=torch.float32, device=q.device)
    l_p = torch.empty_like(m_p)
    acc_p = torch.empty((B * KV, nsplit, G, D), dtype=torch.float32,
                        device=q.device)
    out = torch.empty_like(q)
    lib = build.load("decode_attention")
    err = lib.decode_attention(
        build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cache_len.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), acc_p.data_ptr(),
        out.data_ptr(), B, S, H, KV, D, span, nsplit, int(window),
        ctypes.c_float(1.0 / math.sqrt(D)),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on_error("decode_attention", err)
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


def decode_attention(q, k, v, cache_len, *, window: int = 0) -> torch.Tensor:
    """q [B,H,D]; k, v [B,S,KV,D]; cache_len [] or [B]; static ``window``
    (0 = full attention) -> [B,H,D].  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cache_len, window=window)
    return decode_attention_kernel(q, k, v, cache_len, window=window)


def decode_attention_paged_kernel(q, k_pages, v_pages, block_table,
                                  cache_len) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only, raises otherwise)."""
    B, H, D = q.shape
    cache_len = _rows_i32(cache_len, B, q.device)
    _check(q, k_pages, v_pages, cache_len)
    if block_table.device != q.device or block_table.dtype != torch.int32 \
            or block_table.shape[0] != B or not block_table.is_contiguous():
        raise ValueError("block_table must be a contiguous int32 [B, "
                         "max_pages] on q's device")
    num_pages, page_size, KV, _ = k_pages.shape
    max_pages = block_table.shape[1]
    G = H // KV
    span = split_span(B, KV, max_pages)
    nsplit = -(-max_pages // span)
    # fp32 split-K partials (scratch for the combine pass)
    m_p = torch.empty((B * KV, nsplit, G), dtype=torch.float32, device=q.device)
    l_p = torch.empty_like(m_p)
    acc_p = torch.empty((B * KV, nsplit, G, D), dtype=torch.float32,
                        device=q.device)
    out = torch.empty_like(q)
    lib = build.load("decode_attention_paged")
    err = lib.decode_attention_paged(
        build.DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), cache_len.data_ptr(),
        m_p.data_ptr(), l_p.data_ptr(), acc_p.data_ptr(), out.data_ptr(),
        B, H, KV, D, num_pages, page_size, max_pages, span, nsplit,
        ctypes.c_float(1.0 / math.sqrt(D)),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on_error("decode_attention_paged", err)
    decode_attention_paged_kernel.launches += 1
    return out


decode_attention_paged_kernel.launches = 0


def decode_attention_paged(q, k_pages, v_pages, block_table,
                           cache_len) -> torch.Tensor:
    """q [B,H,D]; pools [num_pages,page_size,KV,D]; block_table
    [B,max_pages] int32 (sentinel >= num_pages = unallocated); cache_len
    [] or [B] -> [B,H,D].  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_pages, v_pages, block_table,
                                            cache_len)
    return decode_attention_paged_kernel(q, k_pages, v_pages, block_table,
                                         cache_len)
