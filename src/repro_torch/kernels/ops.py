"""Dispatch for the kernels (mirror of ``repro.kernels.ops``).  The model
code calls the attention ops with ``impl=cfg.decode_impl``, the dataframe
operators ``hash_partition_histogram`` with their own ``impl``:

* ``"auto"``: the hand-written CUDA kernel for CUDA tensors, the plain
  PyTorch version for CPU tensors (decided by the tensor's device only);
* ``"cuda"``: the kernel, raising on CPU tensors;
* ``"ref"``: the plain version on every device.
"""
from __future__ import annotations

from repro_torch.configs.base import DECODE_IMPLS
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hash_partition as _hp
from repro_torch.kernels import prefill_attention as _pf
from repro_torch.kernels import rmsnorm as _rms


def _check_impl(impl: str) -> None:
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl {impl!r}: expected one of "
                         f"{'|'.join(DECODE_IMPLS)}")


def flash_attention(q, k, v, *, causal: bool = True, impl: str = "auto",
                    q_chunk: int = 1024, kv_chunk: int = 1024):
    """q [B,H,S,D]; k, v [B,KV,S,D] -> [B,H,S,D], differentiable.  On the
    kernel the backward recomputes ``blocks.chunked_attention`` at
    ``q_chunk`` x ``kv_chunk``; the plain version is differentiated
    directly."""
    _check_impl(impl)
    if impl == "auto":
        return _fa.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)
    if impl == "cuda":
        return _fa.flash_attention_autograd(q, k, v, causal=causal,
                                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    return _fa.flash_attention_plain(q, k, v, causal=causal)


def decode_attention(q, k, v, cache_len, *, window: int = 0,
                     impl: str = "auto"):
    """q [B,H,D]; k, v [B,S,KV,D]; cache_len [] or [B] int32; static
    ``window`` (0 = full attention) -> [B,H,D]."""
    _check_impl(impl)
    if impl == "auto":
        return _dec.decode_attention(q, k, v, cache_len, window=window)
    if impl == "cuda":
        return _dec.decode_attention_kernel(q, k, v, cache_len, window=window)
    return _dec.decode_attention_plain(q, k, v, cache_len, window=window)


def decode_attention_paged(q, k_pages, v_pages, block_table, cache_len, *,
                           window: int = 0, impl: str = "auto"):
    """q [B,H,D]; pools [num_pages,page_size,KV,D]; block_table [B,max_pages]
    int32 (sentinel >= num_pages = unallocated); cache_len [B]; static
    ``window`` (0 = full attention) -> [B,H,D]."""
    _check_impl(impl)
    args = (q, k_pages, v_pages, block_table, cache_len)
    if impl == "auto":
        return _dec.decode_attention_paged(*args, window=window)
    if impl == "cuda":
        return _dec.decode_attention_paged_kernel(*args, window=window)
    return _dec.decode_attention_paged_plain(*args, window=window)


def prefill_attention(q, k_new, v_new, k_cache, v_cache, base, chunk_lens,
                      *, impl: str = "auto"):
    """Ragged cache-writing prefill, contiguous layout.  q [B,T,H,D];
    k_new, v_new [B,T,KV,D]; caches [B,S,KV,D] (written in place); base,
    chunk_lens [] or [B] -> (out [B,T,H,D], k_cache, v_cache)."""
    _check_impl(impl)
    args = (q, k_new, v_new, k_cache, v_cache, base, chunk_lens)
    if impl == "auto":
        return _pf.prefill_attention(*args)
    if impl == "cuda":
        return _pf.prefill_attention_kernel(*args)
    return _pf.prefill_attention_plain(*args)


def prefill_attention_paged(q, k_new, v_new, k_pages, v_pages, block_table,
                            base, chunk_lens, *, impl: str = "auto"):
    """Ragged cache-writing prefill through per-row block tables.
    q [B,T,H,D]; k_new, v_new [B,T,KV,D]; pools [num_pages,page_size,KV,D]
    (written in place); block_table [B,max_pages] int32; base, chunk_lens
    [] or [B] -> (out [B,T,H,D], k_pages, v_pages)."""
    _check_impl(impl)
    args = (q, k_new, v_new, k_pages, v_pages, block_table, base, chunk_lens)
    if impl == "auto":
        return _pf.prefill_attention_paged(*args)
    if impl == "cuda":
        return _pf.prefill_attention_paged_kernel(*args)
    return _pf.prefill_attention_paged_plain(*args)


def paged_append(k_pages, v_pages, block_table, idx, k_row, v_row, *,
                 impl: str = "auto"):
    """The paged decode step's cache write: ``k_row``, ``v_row [B, KV, D]``
    into the pools ``[num_pages, page_size, KV, D]`` (in place) at
    positions ``idx`` [B] through ``block_table`` [B, max_pages] int32 ->
    (k_pages, v_pages).  On the kernel, one scatter launch for both
    pools."""
    _check_impl(impl)
    args = (k_pages, v_pages, block_table, idx, k_row, v_row)
    if impl == "auto":
        return _pf.paged_append(*args)
    if impl == "cuda":
        return _pf.paged_append_kernel(*args)
    return (_pf.paged_append_plain(k_pages, block_table, idx, k_row),
            _pf.paged_append_plain(v_pages, block_table, idx, v_row))


def rmsnorm(x, w, *, eps: float = 1e-5, impl: str = "auto"):
    """The fused kernel's RMSNorm (fp32 multiply; not the model's norm):
    x [..., d]; w [d] -> x's shape and dtype."""
    _check_impl(impl)
    if impl == "auto":
        return _rms.rmsnorm(x, w, eps=eps)
    if impl == "cuda":
        return _rms.rmsnorm_kernel(x, w, eps=eps)
    return _rms.rmsnorm_plain(x, w, eps=eps)


def hash_partition_histogram(keys, *, num_buckets: int, impl: str = "auto",
                             block: int = 2048):
    """keys [N] (or [R, N]) -> [ceil(N/block), P] (or [R, ...]) int32
    per-block bucket histograms on every ``impl``; JAX's ``"ref"`` returns
    the global histogram as one block instead."""
    _check_impl(impl)
    if impl == "auto":
        return _hp.hash_partition_histogram(keys, num_buckets=num_buckets,
                                            block=block)
    if impl == "cuda":
        return _hp.hash_partition_histogram_kernel(keys, num_buckets=num_buckets,
                                                   block=block)
    return _hp.hash_partition_histogram_plain(keys, num_buckets=num_buckets,
                                              block=block)
