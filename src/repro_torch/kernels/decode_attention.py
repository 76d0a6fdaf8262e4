"""Decode attention: the CUDA kernels' wrappers and their plain PyTorch
versions (mirror of ``repro.kernels.decode_attention``).

One query token per row attends the row's live prefix ``[0, cache_len)``.
Two layouts, as in JAX:

* ``decode_attention``: the row's own contiguous cache ``[B, S, KV, D]``;
  ``cache_len`` is a scalar or ``[B]`` and a static ``window`` > 0 also
  masks positions before ``cache_len - window``
  (``csrc/decode_attention.cu``).  The wrapper picks the kernel's body
  and cuts the row into spans for it, in one place
  (``contiguous_plan``): the bf16 tensor-core body walks up to
  ``_TC_SPAN`` positions a block (``contiguous_tc_span``), so at S <= 512
  a row is one block and one launch; the CUDA-core body (fp32, or bf16
  tensors that are not 16-byte aligned) keeps split-K spans that leave
  ~``_TARGET_BLOCKS`` blocks (``contiguous_split_span``).  A row of one
  span is written by its block; longer rows write fp32 ``(m, l, acc)``
  partials (``decode_partials``) that a combine pass merges;
* ``decode_attention_paged``: the shared page pool ``[num_pages,
  page_size, KV, D]`` read through the row's block table, with the same
  static ``window`` (``csrc/decode_attention_paged.cu``).  One plan again
  (``paged_plan``): the bf16 tensor-core body walks spans of whole pages
  covering up to ``_TC_SPAN`` positions, so a row of up to 512 positions
  is one block and one launch; the CUDA-core body keeps spans of pages
  that leave ~``_TARGET_BLOCKS`` blocks (``split_span``).  Split rows
  write the partials (``decode_partials``) that the combine pass merges.

Rows with nothing live (``cache_len == 0``) return zeros.

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

# enough (row, KV head, span) blocks of the paged kernel and of the
# contiguous CUDA-core body to cover the card's 132 SMs twice
_TARGET_BLOCKS = 264
# positions the contiguous CUDA-core body stages per step (kTile in the .cu)
_TILE = 32
# cache positions a block of either tensor-core body walks at most: a row
# of the serving max_len (512) is one block, so one launch; contiguous
# spans are whole 16-key tiles (kDecKeys in csrc/decode_tc.cuh), paged
# spans whole pages (at most kMaxSpanPages entries in the .cu)
_TC_SPAN = 512
_TC_TILE = 16


def _splits(B: int, KV: int) -> int:
    """Splits per (row, KV head) that leave about ``_TARGET_BLOCKS``
    blocks in the grid, so short batches split finer."""
    return max(1, -(-_TARGET_BLOCKS // max(1, B * KV)))


def split_span(B: int, KV: int, max_pages: int) -> int:
    """Logical pages per split-K block of the paged kernel."""
    return max(1, -(-max_pages // _splits(B, KV)))


def contiguous_split_span(B: int, KV: int, S: int) -> int:
    """Cache positions per split-K block of the contiguous CUDA-core body,
    in whole tiles."""
    span = -(-S // _splits(B, KV))
    return -(-span // _TILE) * _TILE


def contiguous_tc_span(S: int) -> int:
    """Cache positions per block of the contiguous tensor-core body: whole
    16-key tiles, at most ``_TC_SPAN``."""
    return min(-(-S // _TC_TILE) * _TC_TILE, _TC_SPAN)


def contiguous_plan(dtype: torch.dtype, aligned: bool, B: int, KV: int, S: int):
    """The one decision of which contiguous decode body runs, and how it
    cuts a row: ``(tensor_cores, span, nsplit)``.  The tensor-core body
    takes bf16 tensors that are all 16-byte aligned; anything else runs on
    the CUDA cores.  The C entry point is handed the choice and refuses a
    mismatch; it guesses nothing."""
    tensor_cores = dtype == torch.bfloat16 and aligned
    span = contiguous_tc_span(S) if tensor_cores else contiguous_split_span(B, KV, S)
    return tensor_cores, span, -(-S // span)


def paged_plan(dtype: torch.dtype, aligned: bool, B: int, KV: int, max_pages: int,
               page_size: int):
    """The one decision of which paged decode body runs, and how it cuts a
    row into spans of whole logical pages: ``(tensor_cores, span_pages,
    nsplit)``.  The tensor-core body takes bf16 tensors that are all
    16-byte aligned, and walks at most ``_TC_SPAN`` positions a block (one
    page when a page is longer), so a row of ``max_pages * page_size`` <=
    512 is one span; anything else runs on the CUDA cores with
    ``split_span``'s ~``_TARGET_BLOCKS``-block split."""
    tensor_cores = dtype == torch.bfloat16 and aligned
    span = (min(max(1, _TC_SPAN // page_size), max_pages) if tensor_cores
            else split_span(B, KV, max_pages))
    return tensor_cores, span, -(-max_pages // span)


def decode_partials(nsplit: int, B: int, KV: int, G: int, D: int, device):
    """The fp32 ``(m, l, acc)`` partials of a split row, for the combine
    pass; ``(None, None, None)`` when a row is one span, whose block
    writes ``out`` itself (on any body of either layout)."""
    if nsplit == 1:
        return None, None, None
    m = torch.empty((B * KV, nsplit, G), dtype=torch.float32, device=device)
    return m, torch.empty_like(m), torch.empty((B * KV, nsplit, G, D), dtype=torch.float32,
                                               device=device)


def _check(kernel, q, k, v, cache_len):
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
    if Dk != D or v.shape != k.shape:
        raise ValueError(f"caches {tuple(k.shape)} do not match q's head dim {D}")
    build.check_head_dim(kernel, D)
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
    cache_len = _ref.rows_i32(cache_len, B, q.device)
    _check("decode_attention", q, k, v, cache_len)
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if k.shape[0] != B or G > 32 or S < 1 or window < 0:
        raise ValueError("caches must be [B, S>=1, KV, D] with H/KV <= 32 "
                         "and window >= 0")
    tc, span, nsplit = contiguous_plan(
        q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v)), B, KV, S)
    if tc and D > 128 and G > 16:
        raise ValueError("the tensor-core body takes H/KV <= 16 at head dim 256")
    parts = decode_partials(nsplit, B, KV, G, D, q.device)
    out = torch.empty_like(q)
    build.launch(
        "decode_attention", q,
        build.DTYPE_CODE[q.dtype], int(tc), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cache_len.data_ptr(), *(None if t is None else t.data_ptr() for t in parts),
        out.data_ptr(), B, S, H, KV, D, span, nsplit, int(window),
        ctypes.c_float(1.0 / math.sqrt(D)))
    build.count_launch(decode_attention_kernel)
    return out


decode_attention_kernel.launches = 0


def decode_attention(q, k, v, cache_len, *, window: int = 0) -> torch.Tensor:
    """q [B,H,D]; k, v [B,S,KV,D]; cache_len [] or [B]; static ``window``
    (0 = full attention) -> [B,H,D].  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cache_len, window=window)
    return decode_attention_kernel(q, k, v, cache_len, window=window)


def decode_attention_paged_kernel(q, k_pages, v_pages, block_table, cache_len, *,
                                  window: int = 0) -> torch.Tensor:
    """Launch the paged CUDA kernel (CUDA tensors only, raises
    otherwise)."""
    B, H, D = q.shape
    cache_len = _ref.rows_i32(cache_len, B, q.device)
    _check("decode_attention_paged", q, k_pages, v_pages, cache_len)
    if block_table.device != q.device or block_table.dtype != torch.int32 \
            or block_table.shape[0] != B or not block_table.is_contiguous():
        raise ValueError("block_table must be a contiguous int32 [B, "
                         "max_pages] on q's device")
    num_pages, page_size, KV, _ = k_pages.shape
    max_pages = block_table.shape[1]
    G = H // KV
    if window < 0:
        raise ValueError("window must be >= 0")
    tc, span, nsplit = paged_plan(
        q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)), B, KV,
        max_pages, page_size)
    if tc and G > 32:
        raise ValueError("the tensor-core body takes H/KV <= 32")
    parts = decode_partials(nsplit, B, KV, G, D, q.device)
    out = torch.empty_like(q)
    build.launch(
        "decode_attention_paged", q,
        build.DTYPE_CODE[q.dtype], int(tc), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), cache_len.data_ptr(),
        *(None if t is None else t.data_ptr() for t in parts), out.data_ptr(),
        B, H, KV, D, num_pages, page_size, max_pages, span, nsplit, int(window),
        ctypes.c_float(1.0 / math.sqrt(D)))
    build.count_launch(decode_attention_paged_kernel)
    return out


decode_attention_paged_kernel.launches = 0


def decode_attention_paged(q, k_pages, v_pages, block_table, cache_len, *,
                           window: int = 0) -> torch.Tensor:
    """q [B,H,D]; pools [num_pages,page_size,KV,D]; block_table
    [B,max_pages] int32 (sentinel >= num_pages = unallocated); cache_len
    [] or [B]; static ``window`` (0 = full attention) -> [B,H,D].  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_pages, v_pages, block_table,
                                            cache_len, window=window)
    return decode_attention_paged_kernel(q, k_pages, v_pages, block_table,
                                         cache_len, window=window)
