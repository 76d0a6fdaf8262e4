"""Plain PyTorch oracles of the kernels (mirror of ``repro.kernels.ref``):
the ground truth the CUDA kernels are held against on the card, and the
path CPU tensors take.

One deliberate difference from the JAX oracle: a decode row with no live
position (``cache_len == 0``) returns zeros, as the kernels (the Pallas
ones and the CUDA ones) do, where the JAX oracle returns the mean of V.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def as_rows(x, B: int, device) -> torch.Tensor:
    """Scalar or [B] lengths -> [B] int64 on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(-1).expand(B)


def _gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[num_pages, page, KV, D] pool through a [B, max_pages] table ->
    contiguous [B, max_pages*page, KV, D]; sentinel entries are clamped,
    they only address positions past a row's live prefix."""
    num_pages, page_size, KV, D = pages.shape
    B, max_pages = block_table.shape
    bt = block_table.to(torch.int64).clamp(0, num_pages - 1)
    return pages[bt].reshape(B, max_pages * page_size, KV, D)


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q [B,H,S,D]; k,v [B,KV,S,D] -> [B,H,S,D]; naive full softmax in
    fp32 over the GQA-repeated K/V, output in q's dtype."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def decode_attention_ref(q, k, v, cache_len, *, window: int = 0) -> torch.Tensor:
    """q [B,H,D]; k,v [B,S,KV,D] (cache-native) -> [B,H,D]; ``cache_len``
    [] or [B].  ``window`` > 0 also masks positions before ``cache_len -
    window``.  Rows with no live position are zeros."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    kf = k.repeat_interleave(G, dim=2).float()
    vf = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf) / math.sqrt(D)
    cl = as_rows(cache_len, B, q.device)[:, None, None]
    pos = torch.arange(S, device=q.device)[None, None, :]
    mask = pos < cl
    if window:
        mask &= pos >= cl - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vf)
    out = torch.where(mask.any(dim=-1, keepdim=True), out, 0.0)
    return out.to(q.dtype)


def decode_attention_paged_ref(q, k_pages, v_pages, block_table,
                               cache_len) -> torch.Tensor:
    """Paged oracle: gather each row's pages through its block table into
    a contiguous view, then run the masked reference."""
    return decode_attention_ref(q, _gather_pages(k_pages, block_table),
                                _gather_pages(v_pages, block_table), cache_len)


def prefill_attention_ref(q, k_new, v_new, k_cache, v_cache, base,
                          chunk_lens):
    """Ragged cache-writing prefill oracle, contiguous layout: write row
    ``b``'s first ``chunk_lens[b]`` chunk tokens at offset ``base[b]`` (in
    place; positions outside the row drop) and attend each valid query
    ``i`` causally over ``[0, base[b] + i]``; padding query rows are exact
    zeros.  Returns ``(out [B,T,H,D], k_cache, v_cache)``."""
    from repro_torch.kernels.prefill_attention import write_chunk

    write_chunk(k_cache, k_new, base, chunk_lens)
    write_chunk(v_cache, v_new, base, chunk_lens)
    out = prefill_attend_ref(q, k_cache, v_cache, base, chunk_lens)
    return out, k_cache, v_cache


def prefill_attend_ref(q, kc, vc, base, clens) -> torch.Tensor:
    """Masked causal attention of a [B,T] chunk over a contiguous
    [B,S,KV,D] cache at per-row offsets; padding rows exact zero."""
    B, T, H, D = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    dev = q.device
    base = as_rows(base, B, dev)
    clens = as_rows(clens, B, dev)
    kf = kc.repeat_interleave(G, dim=2).float()  # [B,S,H,D]
    vf = vc.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) / math.sqrt(D)
    qpos = base[:, None] + torch.arange(T, device=dev)[None, :]       # [B,T]
    mask = torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None]
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    valid = torch.arange(T, device=dev)[None, :] < clens[:, None]     # [B,T]
    out = torch.where(valid[:, :, None, None], out, 0.0)
    return out.to(q.dtype)


def prefill_attention_paged_ref(q, k_new, v_new, k_pages, v_pages,
                                block_table, base, chunk_lens):
    """Paged prefill oracle: write the chunk through the block tables (in
    place), gather each row's pages into a contiguous view, and attend.
    Returns ``(out [B,T,H,D], k_pages, v_pages)``."""
    from repro_torch.kernels.prefill_attention import write_chunk_paged

    write_chunk_paged(k_pages, block_table, k_new, base, chunk_lens)
    write_chunk_paged(v_pages, block_table, v_new, base, chunk_lens)
    out = prefill_attend_ref(q, _gather_pages(k_pages, block_table),
                             _gather_pages(v_pages, block_table), base,
                             chunk_lens)
    return out, k_pages, v_pages


def rmsnorm_ref(x, w, *, eps: float = 1e-5) -> torch.Tensor:
    """The fused kernel's RMSNorm: fp32 mean-square and rsqrt, the scale
    multiplied in fp32, cast to x's dtype (the model's ``rmsnorm_apply``
    multiplies in x's dtype instead)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


KNUTH = 2654435761


def hash_u32_ref(keys) -> torch.Tensor:
    """The uint32 hash ``h = k * 2654435761; h ^= h >> 16`` of integer keys
    (cast to uint32 as JAX's ``astype`` does: their low 32 bits), as int64
    in ``[0, 2^32)``: torch has no uint32 shift on the CPU.  The product is
    formed from 16-bit halves, so no intermediate passes 2^63."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo, hi = k & 0xFFFF, k >> 16
    mid = (hi * (KNUTH & 0xFFFF) + lo * (KNUTH >> 16)) & 0xFFFF
    h = (lo * (KNUTH & 0xFFFF) + (mid << 16)) & 0xFFFFFFFF
    return h ^ (h >> 16)


def hash_partition_histogram_ref(keys, *, num_buckets: int) -> torch.Tensor:
    """Global histogram [num_buckets] int32 of the keys' buckets
    ``hash % num_buckets`` (per-block results sum to this)."""
    bucket = hash_u32_ref(keys.reshape(-1)) % num_buckets
    return torch.bincount(bucket, minlength=num_buckets).to(torch.int32)
