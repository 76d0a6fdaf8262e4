"""Ragged cache-writing prefill attention: the CUDA kernels' wrappers,
their plain PyTorch versions, and the cache scatters (mirror of
``repro.kernels.prefill_attention``).

A ``[B, T]`` slab of fresh prompt tokens (row ``b`` carries
``chunk_lens[b]`` valid tokens, the rest right-padding) is written into
each row's cache at its own ``base[b]`` offset, then attended causally
over the row's whole prefix ``[0, base[b] + i]``.  Padding query rows
come out as exact zeros; rows with ``chunk_lens == 0`` are inert.  Two
layouts, as in JAX:

* ``prefill_attention``: contiguous cache rows ``[B, S, KV, D]``
  (``csrc/prefill_attention.cu``: a scatter kernel, then the attention
  kernel, on one stream with no host sync);
* ``prefill_attention_paged``: the shared page pool ``[num_pages,
  page_size, KV, D]`` through per-row block tables
  (``csrc/prefill_attention_paged.cu``: a scatter kernel through the
  tables, then the attention kernel, on one stream with no host sync).

The paged decode step's append of one token per row goes through the
same scatter kernel (``paged_append``).

The JAX functions return new caches; here the caches are updated **in
place** (saving a copy of every cache per call) and returned, so the
signatures stay ``(out, k_cache, v_cache)``.

The dispatchers take the plain version for CPU tensors and launch the
kernel for CUDA tensors; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# the plain versions of the kernels: masked scatter (through the clamped
# table, when paged), fp32 softmax, zeros for padding rows
prefill_attention_plain = _ref.prefill_attention_ref
prefill_attention_paged_plain = _ref.prefill_attention_paged_ref


def _put_rows(flat: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor,
              keep: torch.Tensor) -> None:
    """``flat[tgt[i]] = vals[i]`` for every ``i`` with ``keep[i]``, in
    place, with no host sync (a boolean-mask index would sync the card's
    host).  A dropped row writes the first kept row's value to that row's
    target again, so a duplicate target carries one value and the order
    of the writes does not matter; with no kept row every row writes
    ``flat[0]`` back onto itself.  flat [N, W]; tgt [M] int64; vals
    [M, W]; keep [M] bool."""
    # index_select, not tgt[first]: a 0-d tensor index is read on the host
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    live = keep.any()
    vals = vals.to(flat.dtype)
    fb_t = torch.where(live, tgt.index_select(0, first), 0)
    fb_v = torch.where(live, vals.index_select(0, first), flat[:1])
    flat.index_copy_(0, torch.where(keep, tgt, fb_t), torch.where(keep[:, None], vals, fb_v))


def write_chunk(cache: torch.Tensor, new: torch.Tensor, base,
                chunk_lens) -> torch.Tensor:
    """Scatter ``new [B, T, ...]`` into ``cache [B, S, ...]`` at per-row
    offsets ``base``, in place and without a host sync; positions at or
    past ``chunk_lens[b]`` drop, and so do positions outside ``[0, S)``."""
    B, T, S = new.shape[0], new.shape[1], cache.shape[1]
    dev = cache.device
    j = torch.arange(T, device=dev)[None, :]
    pos = _ref.as_rows(base, B, dev)[:, None] + j
    keep = (j < _ref.as_rows(chunk_lens, B, dev)[:, None]) & (pos >= 0) & (pos < S)
    tgt = torch.arange(B, device=dev)[:, None] * S + pos
    _put_rows(cache.view(B * S, -1), tgt.reshape(-1), new.reshape(B * T, -1),
              keep.reshape(-1))
    return cache


def write_chunk_paged(pages: torch.Tensor, block_table: torch.Tensor,
                      new: torch.Tensor, base, chunk_lens) -> torch.Tensor:
    """Scatter ``new [B, T, ...]`` through per-row block tables into the
    shared page pool, in place and without a host sync.  Unallocated
    logical pages hit the sentinel (>= num_pages) and the write drops, as
    do padding positions (``j >= chunk_lens[b]``)."""
    num_pages, page_size = pages.shape[0], pages.shape[1]
    B, T = new.shape[0], new.shape[1]
    max_pages = block_table.shape[1]
    dev = pages.device
    base = _ref.as_rows(base, B, dev)
    clens = _ref.as_rows(chunk_lens, B, dev)
    j = torch.arange(T, device=dev)[None, :]
    pos = base[:, None] + j
    lp = pos // page_size
    rows = torch.arange(B, device=dev)[:, None]
    phys = torch.where(
        (j < clens[:, None]) & (lp < max_pages),
        block_table.to(torch.int64)[rows, lp.clamp(max=max_pages - 1)],
        num_pages)
    keep = (phys >= 0) & (phys < num_pages)
    _put_rows(pages.view(num_pages * page_size, -1),
              (phys * page_size + pos % page_size).reshape(-1), new.reshape(B * T, -1),
              keep.reshape(-1))
    return pages


def paged_append_plain(pages: torch.Tensor, block_table: torch.Tensor,
                       idx: torch.Tensor, row_vals: torch.Tensor) -> torch.Tensor:
    """Scatter one new position per row into the shared page pool, in
    place: ``write_chunk_paged`` of one token at ``idx`` [B] (or a
    scalar); unallocated / out-of-range logical pages hit the sentinel
    (>= num_pages) and the write drops."""
    # the chunk length made on the device: a Python 1 would be copied from
    # the host, a synchronous copy
    ones = torch.ones(row_vals.shape[0], dtype=torch.int32, device=pages.device)
    return write_chunk_paged(pages, block_table, row_vals[:, None], idx, ones)


def write_chunk_paged_kernel(k_pages, v_pages, block_table, k_new, v_new,
                             base, chunk_lens=None):
    """Launch the scatter kernel (CUDA tensors only, raises otherwise):
    ``k_new``, ``v_new [B, T, ...]`` into both pools through the block
    tables, in place, where ``write_chunk_paged`` writes them (bitwise);
    ``chunk_lens`` None makes every token live.  Returns ``(k_pages,
    v_pages)``."""
    if k_pages.device.type != "cuda":
        raise ValueError(f"paged scatter kernel needs CUDA tensors, got {k_pages.device}")
    B = k_new.shape[0]
    for name, t in (("v_pages", v_pages), ("k_new", k_new), ("v_new", v_new),
                    ("block_table", block_table)):
        if t.device != k_pages.device:
            raise ValueError(f"{name} on {t.device}, k_pages on {k_pages.device}")
    if v_pages.shape != k_pages.shape or v_new.shape != k_new.shape \
            or k_new.shape[2:] != k_pages.shape[2:]:
        raise ValueError("shape mismatch: pools [P, page, ...], new [B, T, ...] "
                         "with the pools' trailing dims")
    if k_new.dtype != k_pages.dtype or v_new.dtype != k_pages.dtype \
            or v_pages.dtype != k_pages.dtype or k_pages.element_size() % 2:
        raise ValueError("pools and new rows must share one dtype of 2 or 4 bytes")
    if block_table.dtype != torch.int32 or block_table.shape[0] != B \
            or not block_table.is_contiguous():
        raise ValueError("block_table must be a contiguous int32 [B, max_pages]")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the pools must be contiguous")
    dev = k_pages.device
    clens32 = None if chunk_lens is None else _ref.rows_i32(chunk_lens, B, dev)
    _launch_scatter(k_pages, v_pages, block_table, k_new.contiguous(), v_new.contiguous(),
                    _ref.rows_i32(base, B, dev), clens32)
    return k_pages, v_pages


write_chunk_paged_kernel.launches = 0


def _launch_scatter(k_pages, v_pages, block_table, k_new, v_new, base32,
                    clens32) -> None:
    """The scatter's launch on checked, contiguous tensors."""
    num_pages, page_size = k_pages.shape[0], k_pages.shape[1]
    row_elems = k_pages.numel() // max(num_pages * page_size, 1)
    build.launch(
        "paged_scatter", k_pages,
        k_pages.element_size(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        base32.data_ptr(), None if clens32 is None else clens32.data_ptr(),
        k_new.shape[0], k_new.shape[1], row_elems, num_pages, page_size,
        block_table.shape[1])
    build.count_launch(write_chunk_paged_kernel)


def paged_append_kernel(k_pages, v_pages, block_table, idx, k_row, v_row):
    """The decode step's append of ``k_row``, ``v_row [B, ...]`` at
    positions ``idx`` [B]: one scatter launch for both pools (CUDA tensors
    only).  Returns ``(k_pages, v_pages)``."""
    return write_chunk_paged_kernel(
        k_pages, v_pages, block_table, k_row.to(k_pages.dtype)[:, None],
        v_row.to(v_pages.dtype)[:, None], idx)


def paged_append(k_pages, v_pages, block_table, idx, k_row, v_row):
    """Append one position per row to both pools, in place; CPU tensors
    take the plain scatter, CUDA tensors the kernel.  Returns ``(k_pages,
    v_pages)``."""
    if k_pages.device.type == "cpu":
        return (paged_append_plain(k_pages, block_table, idx, k_row),
                paged_append_plain(v_pages, block_table, idx, v_row))
    return paged_append_kernel(k_pages, v_pages, block_table, idx, k_row, v_row)


def _check_chunk(kernel, q, k_new, v_new, k_cache, v_cache):
    """Device, dtype, head-dim and contiguity checks the two kernels share
    (caches: the contiguous rows or the page pools)."""
    B, T, H, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"prefill kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in build.KERNEL_DTYPES:
        raise ValueError(f"prefill kernel takes fp32/bf16, got {q.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    KV, Dk = k_cache.shape[2], k_cache.shape[3]
    if Dk != D or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q's head dim {D}")
    build.check_head_dim(kernel, D)
    if H % KV or H // KV > 128 or k_new.shape != (B, T, KV, D) \
            or v_new.shape != k_new.shape:
        raise ValueError("shape mismatch: q [B,T,H,D], k/v_new [B,T,KV,D], "
                         "H % KV == 0, H/KV <= 128")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def prefill_attention_kernel(q, k_new, v_new, k_cache, v_cache, base,
                             chunk_lens):
    """Launch the CUDA kernels (CUDA tensors only, raises otherwise): the
    chunk scatter into the caches, in place, then the attention.  Returns
    ``(out [B, T, H, D], k_cache, v_cache)``."""
    _check_chunk("prefill_attention", q, k_new, v_new, k_cache, v_cache)
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B:
        raise ValueError("caches must be [B, S, KV, D] with q's B")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    base32 = _ref.rows_i32(base, B, q.device)
    clens32 = _ref.rows_i32(chunk_lens, B, q.device)
    out = torch.empty_like(q)
    build.launch(
        "prefill_attention", q,
        build.DTYPE_CODE[q.dtype], q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        base32.data_ptr(), clens32.data_ptr(), out.data_ptr(), B, T, S, H, KV,
        D, ctypes.c_float(1.0 / math.sqrt(D)))
    build.count_launch(prefill_attention_kernel)
    return out, k_cache, v_cache


prefill_attention_kernel.launches = 0


def prefill_attention(q, k_new, v_new, k_cache, v_cache, base, chunk_lens):
    """q [B,T,H,D]; k_new, v_new [B,T,KV,D]; caches [B,S,KV,D] (updated in
    place); base, chunk_lens [] or [B].  CPU tensors take the plain
    version, CUDA tensors the kernels.  Returns ``(out, k_cache,
    v_cache)``."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                       base, chunk_lens)
    return prefill_attention_kernel(q, k_new, v_new, k_cache, v_cache, base,
                                    chunk_lens)


def _check_paged(q, k_new, v_new, k_pages, v_pages, block_table):
    _check_chunk("prefill_attention_paged", q, k_new, v_new, k_pages, v_pages)
    if block_table.device != q.device:
        raise ValueError(f"block_table on {block_table.device}, q on {q.device}")
    if block_table.dtype != torch.int32:
        raise ValueError("block_table must be int32")
    if block_table.shape[0] != q.shape[0] or not block_table.is_contiguous():
        raise ValueError("block_table must be a contiguous [B, max_pages]")


def prefill_attention_paged_kernel(q, k_new, v_new, k_pages, v_pages,
                                   block_table, base, chunk_lens):
    """Launch the CUDA kernels (CUDA tensors only, raises otherwise): the
    chunk scatter into the pools, in place, then the attention, with no
    host sync.  Returns ``(out [B, T, H, D], k_pages, v_pages)``."""
    _check_paged(q, k_new, v_new, k_pages, v_pages, block_table)
    B, T, H, D = q.shape
    num_pages, page_size, KV, _ = k_pages.shape
    max_pages = block_table.shape[1]
    base32 = _ref.rows_i32(base, B, q.device)
    clens32 = _ref.rows_i32(chunk_lens, B, q.device)
    _launch_scatter(k_pages, v_pages, block_table, k_new.contiguous(),
                    v_new.contiguous(), base32, clens32)
    out = torch.empty_like(q)
    build.launch(
        "prefill_attention_paged", q,
        build.DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), base32.data_ptr(),
        clens32.data_ptr(), out.data_ptr(), B, T, H, KV, D, num_pages,
        page_size, max_pages, ctypes.c_float(1.0 / math.sqrt(D)))
    build.count_launch(prefill_attention_paged_kernel)
    return out, k_pages, v_pages


prefill_attention_paged_kernel.launches = 0


def prefill_attention_paged(q, k_new, v_new, k_pages, v_pages, block_table,
                            base, chunk_lens):
    """q [B,T,H,D]; k_new, v_new [B,T,KV,D]; pools [num_pages,page_size,KV,D]
    (updated in place); block_table [B,max_pages] int32 (sentinel >=
    num_pages = unallocated); base, chunk_lens [] or [B].  CPU tensors take
    the plain version, CUDA tensors the kernel.  Returns
    ``(out, k_pages, v_pages)``."""
    if q.device.type == "cpu":
        return prefill_attention_paged_plain(
            q, k_new, v_new, k_pages, v_pages, block_table, base, chunk_lens)
    return prefill_attention_paged_kernel(
        q, k_new, v_new, k_pages, v_pages, block_table, base, chunk_lens)
