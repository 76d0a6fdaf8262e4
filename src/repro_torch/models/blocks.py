"""Transformer building blocks (mirror of the GQA subset of
``repro.models.blocks``): RMSNorm, RoPE, chunked flash-style attention,
GQA attention without a cache (training) and over a KV cache (paged and
contiguous serving), and the SwiGLU/GeGLU/GELU MLP.

Every block is a pair of functions: ``<kind>_specs(cfg)`` declares the
parameters, ``<kind>_apply(cfg, params, x, ...)`` runs the forward.
Activations are ``[batch, seq, ...]``; compute runs in
``cfg.compute_dtype`` while norms and softmax accumulate in fp32.  Caches
are updated in place (the JAX blocks return new ones).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Param
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> Dict[str, Param]:
    return {"scale": Param((d,), (None,), init="ones")}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 variance reduction; the scaling multiply stays in the input
    dtype, as in the JAX model (which the fused Pallas rmsnorm does not
    reproduce in bf16)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * params["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] integer."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].float() * freqs             # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash-style chunked attention (differentiable, O(chunk) memory): the
# function the JAX model trains through, and the backward of the flash
# kernel's autograd Function
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


def _check_prefill_base(raw_len) -> None:
    """S>1 prefill without ``chunk_lens`` attends over the fresh K/V only,
    which is exact iff the cache is empty: the base must be a scalar 0."""
    if torch.as_tensor(raw_len).ndim != 0:
        raise ValueError(
            "prefill (S>1) requires a scalar cache length; per-slot "
            "lengths only apply to single-token decode")
    if int(raw_len) != 0:
        raise NotImplementedError(
            f"prefill (S>1) writes into an EMPTY cache (got base length "
            f"{int(raw_len)}); pass chunk_lens for the ragged prefill over "
            f"a warm cache")


def _attn_chunk(q, k, v, qpos, kpos, causal: bool, window: int, scale: float):
    """One (q-chunk x kv-chunk) tile.  q [B,qc,H,D]; k, v [B,kc,H,D] ->
    the tile's fp32 (max [B,H,qc], sum [B,H,qc], out [B,qc,H,D])."""
    s = torch.einsum("bqhd,bchd->bhqc", q.float(), k.float()) * scale
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqc,bchd->bqhd", p.to(v.dtype), v)
    return m, l, o.float()


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,D]; k, v [B,Skv,KV,D] -> [B,Sq,H,D] in q's dtype.

    A loop over q chunks, each visiting only the KV chunks its causal
    (and window) range can see, with a running fp32 softmax across them.
    Under autograd each KV step is checkpointed (its score tile is
    recomputed in the backward instead of kept), as JAX checkpoints its
    scan body.  One difference from JAX: a last KV chunk that runs past
    Skv is cut short here, where ``dynamic_slice`` shifts it back over
    keys already counted and labels them with the wrong positions
    (ROADMAP.md queue 3)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    dev = q.device
    outs = []
    for q_lo in range(0, Sq, q_chunk):
        qc = min(q_chunk, Sq - q_lo)
        qblk = q[:, q_lo:q_lo + qc]
        qpos = q_offset + q_lo + torch.arange(qc, device=dev)
        hi = min(q_offset + q_lo + qc if causal else Skv, Skv)
        lo = 0
        if window:
            lo = max(0, q_offset + q_lo - window + 1) // kv_chunk * kv_chunk
        nkv = max(-(-(hi - lo) // kv_chunk), 1)

        # qblk and qpos bound now: the checkpoint reruns this body in the
        # backward pass, after the loop has moved on to later q chunks
        def kv_body(m_prev, l_prev, o_prev, k_lo, qblk=qblk, qpos=qpos):
            kblk = k[:, k_lo:k_lo + kv_chunk]
            vblk = v[:, k_lo:k_lo + kv_chunk]
            if KV != H:  # GQA repeat of the live tile only
                kblk = kblk.repeat_interleave(H // KV, dim=2)
                vblk = vblk.repeat_interleave(H // KV, dim=2)
            kpos = k_lo + torch.arange(kblk.shape[1], device=dev)
            m_new, l_new, o_new = _attn_chunk(qblk, kblk, vblk, qpos, kpos,
                                              causal, window, scale)
            m_run = torch.maximum(m_prev, m_new)
            a = torch.exp(m_prev - m_run)  # [B,H,qc]
            b = torch.exp(m_new - m_run)
            l_run = l_prev * a + l_new * b
            o_run = (o_prev * a.transpose(1, 2)[..., None]
                     + o_new * b.transpose(1, 2)[..., None])
            return m_run, l_run, o_run

        m = torch.full((B, H, qc), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        o = torch.zeros((B, qc, H, D), dtype=torch.float32, device=dev)
        for j in range(nkv):
            if torch.is_grad_enabled():
                m, l, o = checkpoint(kv_body, m, l, o, lo + j * kv_chunk,
                                     use_reentrant=False)
            else:
                m, l, o = kv_body(m, l, o, lo + j * kv_chunk)
        outs.append(o / l.clamp(min=1e-30).transpose(1, 2)[..., None])
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.to(q.dtype)


def _self_attention(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    """Causal attention of q [B,S,H,D] over the fresh k, v [B,S,KV,D]
    through the flash op, on [B,H,S,D] views (no copies)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            impl=cfg.decode_impl, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# Contiguous cache append (the paged one is ops.paged_append)
# ---------------------------------------------------------------------------


def _slot_append(cache: torch.Tensor, idx: torch.Tensor,
                 row_vals: torch.Tensor) -> torch.Tensor:
    """Write one new position per row into the contiguous cache ``[B, S,
    ...]``, in place, at ``idx`` [B]; a row whose ``idx`` lies outside
    ``[0, S)`` writes nothing (JAX's ``mode="drop"``, except that JAX
    first wraps a negative index by S; the engine marks the rows that
    must not decode with -1).  One write per row, so clamping the index
    and writing back the old value where the row drops cannot collide,
    and there is no host sync."""
    S = cache.shape[1]
    idx = idx.to(torch.int64)
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = idx.clamp(0, S - 1)
    keep = ((idx >= 0) & (idx < S)).reshape((-1,) + (1,) * (row_vals.ndim - 1))
    cache[rows, pos] = torch.where(keep, row_vals.to(cache.dtype), cache[rows, pos])
    return cache


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, Dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.padded_gqa()
    return {
        "norm": rmsnorm_specs(d),
        "wq": Param((d, H, Dh), ("embed", "heads", None)),
        "wk": Param((d, KV, Dh), ("embed", "kv_heads", None)),
        "wv": Param((d, KV, Dh), ("embed", "kv_heads", None)),
        "wo": Param((H, Dh, d), ("heads", None, "embed")),
    }


def _cached_attention(cfg: ModelConfig, q, k, v, cache: Dict,
                      chunk_lens: Optional[torch.Tensor]):
    """The cache branches of ``attn_apply``: q [B,S,H,D] and the fresh k, v
    [B,S,KV,D] after RoPE -> (o [B,S,H,D], new cache)."""
    Bsz, S = k.shape[0], k.shape[1]
    length = torch.as_tensor(cache["len"], device=q.device)
    paged = "k_pages" in cache
    if S > 1 and chunk_lens is None:
        if paged:
            raise NotImplementedError(
                "paged prefill without chunk_lens is not supported: pass "
                "per-row chunk_lens to run the ragged cache-writing prefill "
                "through the block tables")
        _check_prefill_base(cache["len"])
        if S > cache["k"].shape[1]:
            raise ValueError(f"a {S}-token prefill does not fit a cache of "
                             f"{cache['k'].shape[1]} positions")
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        return (_self_attention(cfg, q, k, v),
                {"k": cache["k"], "v": cache["v"], "len": S})
    if S > 1:
        base = length.to(torch.int32).reshape(-1).expand(Bsz)
        chunk_lens = chunk_lens.to(torch.int32)
        if paged:
            o, k_c, v_c = ops.prefill_attention_paged(
                q, k, v, cache["k_pages"], cache["v_pages"],
                cache["block_table"], base, chunk_lens, impl=cfg.decode_impl)
        else:
            o, k_c, v_c = ops.prefill_attention(
                q, k.contiguous(), v.contiguous(), cache["k"], cache["v"], base,
                chunk_lens, impl=cfg.decode_impl)
        new_len = base + chunk_lens
    elif paged:
        k_c, v_c = ops.paged_append(cache["k_pages"], cache["v_pages"],
                                    cache["block_table"], length, k[:, 0], v[:, 0],
                                    impl=cfg.decode_impl)
        new_len = length + 1
        o = ops.decode_attention_paged(q[:, 0], k_c, v_c, cache["block_table"],
                                       new_len, impl=cfg.decode_impl)[:, None]
    else:
        k_c, v_c = cache["k"], cache["v"]
        if length.ndim == 1:
            _slot_append(k_c, length, k[:, 0])
            _slot_append(v_c, length, v[:, 0])
        else:
            pos = length.to(torch.int64).clamp(0, k_c.shape[1] - 1).reshape(1)
            k_c.index_copy_(1, pos, k.to(k_c.dtype))
            v_c.index_copy_(1, pos, v.to(v_c.dtype))
        new_len = length + 1
        o = ops.decode_attention(q[:, 0], k_c, v_c, new_len,
                                 impl=cfg.decode_impl)[:, None]
    if paged:
        return o, {"k_pages": k_c, "v_pages": v_c,
                   "block_table": cache["block_table"], "len": new_len}
    return o, {"k": k_c, "v": v_c, "len": new_len}


def attn_apply(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    *,
    window: int = 0,
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Causal GQA self-attention, without a cache or over a KV cache:
    paged ``{"k_pages", "v_pages", "block_table", "len"}`` or contiguous
    ``{"k", "v", "len"}`` (``[B, S, KV, D]`` rows).

    Without a cache (training) the sequence attends causally over itself
    through the flash op, differentiably.  With ``S > 1`` and
    ``chunk_lens`` ([B]) it runs the ragged cache-writing prefill: row
    ``b``'s first ``chunk_lens[b]`` tokens append at offset
    ``cache["len"][b]`` and attend the full cached prefix.  With ``S > 1``
    and no ``chunk_lens`` the contiguous cache must be empty (a scalar
    length 0): the prompt's K/V are written at offset 0 and the sequence
    attends over itself through the flash op.  With ``S == 1`` each row
    appends at its length and attends its prefix: a [B] ``len`` is
    continuous-batching decode (a contiguous row whose length is negative
    or past its cache drops its write), a scalar ``len`` decodes every row
    at one position (the contiguous write clamps to the last position, as
    ``dynamic_update_slice`` does).  Caches are written in place; the
    returned cache holds the same tensors and the new lengths."""
    if window:
        raise NotImplementedError(
            "windowed attention (ring caches) is a later slice of the port "
            "(ROADMAP.md queue 1, item 6)")
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE is a later slice of the port (ROADMAP.md queue 1, item 9)")
    cdt = cfg.compute_dtype
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    q = torch.einsum("bsd,dhk->bshk", h, params["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", h, params["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", h, params["wv"].to(cdt))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o, new_cache = _self_attention(cfg, q, k, v), None
    else:
        o, new_cache = _cached_attention(cfg, q, k, v, cache, chunk_lens)
    y = torch.einsum("bshk,hkd->bsd", o.to(cdt), params["wo"].to(cdt))
    return x + y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    specs = {
        "norm": rmsnorm_specs(d),
        "w1": Param((d, ff), ("embed", "mlp")),
        "w2": Param((ff, d), ("mlp", "embed")),
    }
    if cfg.mlp_act in ("swiglu", "geglu"):
        specs["w3"] = Param((d, ff), ("embed", "mlp"))
    return specs


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    cdt = cfg.compute_dtype
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    u = h @ params["w1"].to(cdt)
    if "w3" in params:
        u = _act(cfg.mlp_act, u) * (h @ params["w3"].to(cdt))
    else:
        u = _act(cfg.mlp_act, u)
    y = u @ params["w2"].to(cdt)
    return x + y.to(x.dtype)
