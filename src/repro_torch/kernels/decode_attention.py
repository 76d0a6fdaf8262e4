"""Split-K paged decode attention: the CUDA kernel's wrapper and its plain
PyTorch version (mirror of ``repro.kernels.decode_attention``'s
``decode_attention_paged``).

One query token per row attends the row's live prefix ``[0, cache_len)``,
read from the shared page pool ``[num_pages, page_size, KV, D]`` through
the row's block table.  The kernel (``csrc/decode_attention_paged.cu``)
reduces each span of logical pages into an fp32 ``(m, l, acc)`` partial;
a combine pass in the same library merges the partials into ``[B, H, D]``
in q's dtype.  Rows with ``cache_len == 0`` return zeros.

``decode_attention_paged`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# the plain version of the kernel: gather through the clamped table, fp32
# softmax, zeros for empty rows
decode_attention_paged_plain = _ref.decode_attention_paged_ref

# enough (row, KV head, page span) blocks to cover the card's 132 SMs twice
_TARGET_BLOCKS = 264


def split_span(B: int, KV: int, max_pages: int) -> int:
    """Logical pages per split-K block: as many as still leave about
    ``_TARGET_BLOCKS`` blocks in the grid, so short batches split finer."""
    splits = max(1, -(-_TARGET_BLOCKS // (B * KV)))
    return max(1, -(-max_pages // splits))


def _check(q, k_pages, v_pages, block_table, cache_len):
    B, H, D = q.shape
    num_pages, page_size, KV, Dk = k_pages.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("cache_len", cache_len)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in build.KERNEL_DTYPES:
        raise ValueError(f"decode kernel takes fp32/bf16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("page pools must have q's dtype")
    if block_table.dtype != torch.int32:
        raise ValueError("block_table must be int32")
    if D not in build.HEAD_DIMS or Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"head dim {D} (pools {tuple(k_pages.shape)}) not in "
                         f"{build.HEAD_DIMS}")
    if H % KV or block_table.shape[0] != B or cache_len.shape != (B,):
        raise ValueError("shape mismatch: q [B,H,D], block_table "
                         "[B,max_pages], cache_len [B], H % KV == 0")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention_paged_kernel(q, k_pages, v_pages, block_table,
                                  cache_len) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only, raises otherwise)."""
    B, H, D = q.shape
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    cache_len = cache_len.to(torch.int32).expand(B).contiguous()
    _check(q, k_pages, v_pages, block_table, cache_len)
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
