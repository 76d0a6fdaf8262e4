"""Transformer building blocks (mirror of ``repro.models.blocks``):
RMSNorm, RoPE and M-RoPE, chunked flash-style attention, GQA attention
(causal or full self-attention, windowed over a ring cache, or
cross-attention to encoder states) and MLA attention without a cache
(training) and over a KV cache (paged and contiguous serving), the
SwiGLU/GeGLU/GELU MLP, and the GShard capacity-based top-k MoE (einsum
and gather dispatch).

Every block is a pair of functions: ``<kind>_specs(cfg)`` declares the
parameters, ``<kind>_apply(cfg, params, x, ...)`` runs the forward.
Activations are ``[batch, seq, ...]``; compute runs in
``cfg.compute_dtype`` while norms and softmax accumulate in fp32.  Caches
are updated in place (the JAX blocks return new ones).
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Param
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.prefill_attention import (paged_append_plain, write_chunk,
                                                   write_chunk_paged)
from repro_torch.kernels.ref import _gather_pages, as_rows, prefill_attend_ref

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> Dict[str, Param]:
    return {"scale": Param((d,), (None,), init="ones")}


class _Naming(threading.local):
    selecting = False  # inside a save_block_outputs unit (selecting_block_outputs)
    inside = False     # inside block_out, while selecting


_NAMING = _Naming()


def block_out(fn, *args):
    """``fn(*args)``, its ops named ``block_out`` as JAX's
    ``checkpoint_name(y, "block_out")`` names a block's output projection
    (attention, MLA, MLP and RG-LRU blocks).  The name is set only inside
    :func:`selecting_block_outputs`, the unit that ``models.lm``
    checkpoints under ``remat_policy="save_block_outputs"``, whose policy
    saves the matmuls so named and recomputes everything else; elsewhere
    this is a plain call."""
    if not _NAMING.selecting:
        return fn(*args)
    _NAMING.inside = True
    try:
        return fn(*args)
    finally:
        _NAMING.inside = False


def naming_block_out() -> bool:
    """Whether this thread runs inside a named :func:`block_out`."""
    return _NAMING.inside


def selecting_block_outputs(fn):
    """``fn`` with :func:`block_out` naming on while it runs, on whichever
    thread runs it: the checkpointed unit's forward and its recompute in
    the backward."""
    @functools.wraps(fn)
    def run(*args):
        was, _NAMING.selecting = _NAMING.selecting, True
        try:
            return fn(*args)
        finally:
            _NAMING.selecting = was
    return run


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 variance reduction; the scaling multiply stays in the input
    dtype, as in the JAX model (which the fused Pallas rmsnorm does not
    reproduce in bf16)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * params["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: [B, S, H, D]; positions: [B, S, 3]
    (t, h, w); ``sections`` splits the D/2 rotary frequencies into (t, h,
    w) groups: frequency i turns with the position of its group."""
    if positions.ndim != 3:
        raise ValueError(f"M-RoPE takes [B, S, 3] positions, got {tuple(positions.shape)}")
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                   # [D/2]
    sec_idx = [i for i, s in enumerate(sections) for _ in range(s)][: d // 2]
    # each frequency's (t, h or w) position times the frequency: the
    # entry JAX picks from its [B,S,D/2,3] product
    angles = positions[..., sec_idx].float() * freqs          # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope_or_mrope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if positions.ndim == 3:  # M-RoPE positions given to a plain RoPE config
        positions = positions[..., 0]
    return apply_rope(x, positions, cfg.rope_theta)


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
    # a 0-d card tensor is read to the host here: only a prefill without
    # chunk_lens gets here (once a layer), never a serving step
    if int(raw_len) != 0:  # sync-ok: the no-chunk prefill's probe of its base
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


def _self_attention(cfg: ModelConfig, q, k, v, causal: bool = True) -> torch.Tensor:
    """Causal or full attention of q [B,S,H,D] over the fresh k, v
    [B,S,KV,D] through the flash op, on [B,H,S,D] views (no copies)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
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


def _windowed_attention(cfg: ModelConfig, q, k, v, window: int) -> torch.Tensor:
    """Causal attention of q over the fresh k, v within ``window``
    positions: the chunked attention, as JAX trains and prefills local
    blocks (the flash kernel takes no window, nor does JAX's)."""
    return chunked_attention(q, k, v, causal=True, window=window,
                             q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)


def _cached_attention(cfg: ModelConfig, q, k, v, cache: Dict,
                      chunk_lens: Optional[torch.Tensor], window: int = 0):
    """The cache branches of ``attn_apply``: q [B,S,H,D] and the fresh k, v
    [B,S,KV,D] after RoPE -> (o [B,S,H,D], new cache).  With ``window``
    the contiguous cache is a ring of ``slots`` positions: position p
    lives at slot p % slots and a decode attends the min(len, slots)
    slots written."""
    Bsz, S = k.shape[0], k.shape[1]
    length = torch.as_tensor(cache["len"], device=q.device)
    paged = "k_pages" in cache
    if paged and window:
        raise NotImplementedError(
            "windowed attention over a paged cache needs ring-aware "
            "page recycling; the engine restricts paged serving to "
            "full-attention blocks")
    if S > 1 and chunk_lens is None:
        if paged:
            raise NotImplementedError(
                "paged prefill without chunk_lens is not supported: pass "
                "per-row chunk_lens to run the ragged cache-writing prefill "
                "through the block tables")
        _check_prefill_base(cache["len"])
        slots = cache["k"].shape[1]
        if window and S >= slots:
            # the ring keeps the last `slots` positions, each at its
            # position-mod-slots slot
            ring = (S - slots + torch.arange(slots, device=q.device)) % slots
            cache["k"][:, ring] = k[:, S - slots:].to(cache["k"].dtype)
            cache["v"][:, ring] = v[:, S - slots:].to(cache["v"].dtype)
        elif S > slots:
            raise ValueError(f"a {S}-token prefill does not fit a cache of "
                             f"{slots} positions")
        else:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        o = (_windowed_attention(cfg, q, k, v, window) if window
             else _self_attention(cfg, q, k, v))
        return o, {"k": cache["k"], "v": cache["v"], "len": S}
    if S > 1:
        if window:
            raise NotImplementedError(
                "windowed attention does not support chunked prefill "
                "over a warm cache (ring writes need the full prompt)")
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
        slots = k_c.shape[1]
        # a ring writes position p at slot p % slots (never dropped)
        slot = torch.remainder(length, slots) if window else length
        if length.ndim == 1:
            _slot_append(k_c, slot, k[:, 0])
            _slot_append(v_c, slot, v[:, 0])
        else:
            pos = slot.to(torch.int64).clamp(0, slots - 1).reshape(1)
            k_c.index_copy_(1, pos, k.to(k_c.dtype))
            v_c.index_copy_(1, pos, v.to(v_c.dtype))
        new_len = length + 1
        # a ring attends every slot written: all of them once it is warm
        lens = torch.clamp(new_len, max=slots) if window else new_len
        o = ops.decode_attention(q[:, 0], k_c, v_c, lens,
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
    causal: bool = True,
    window: int = 0,
    kv_source: Optional[torch.Tensor] = None,
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention: self-attention (causal, or full with ``causal=False``)
    without a cache or over a KV cache, or cross-attention to the encoder
    states ``kv_source`` [B, Skv, d] (projected to K/V without the block's
    norm; only q goes through it).  RoPE (M-RoPE for a config with
    ``mrope_sections``, on [B, S, 3] positions) turns q and k of causal
    self-attention only, as in JAX: an encoder's full attention and a
    cross-attention carry no rotation.  Self caches are paged
    ``{"k_pages", "v_pages", "block_table", "len"}`` or contiguous ``{"k",
    "v", "len"}`` (``[B, S, KV, D]`` rows); a cross cache ``{"xk", "xv",
    "xlen"}`` holds the encoder's K/V [B, Skv, KV, D] and a scalar length.
    ``window`` > 0 (a local block) attends the last ``window`` positions
    only, over a contiguous ring cache of ``min(max_len, window)`` slots.

    Without a cache (training) the sequence attends over itself through
    the flash op, differentiably (through ``chunked_attention`` with a
    window); a cross-attention attends the encoder states through
    ``chunked_attention`` (Sq != Skv).  With a cross cache the one new
    token attends the cached encoder K/V through the decode op, and the
    cache comes back unchanged (JAX passes a dummy ``kv_source`` there and
    projects it for nothing; the port passes none).  With ``S > 1`` and
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
    ``dynamic_update_slice`` does).  A ring's prefill of ``S`` >= its
    slots keeps the last ``slots`` positions; its decodes write slot ``len
    % slots`` and attend ``min(len + 1, slots)`` slots through the decode
    op.  Caches are written in place; the returned cache holds the same
    tensors and the new lengths."""
    cdt = cfg.compute_dtype
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    q = torch.einsum("bsd,dhk->bshk", h, params["wq"].to(cdt))
    if cache is not None and "xk" in cache:
        o = ops.decode_attention(q[:, 0].contiguous(), cache["xk"], cache["xv"],
                                 cache["xlen"], impl=cfg.decode_impl)[:, None]
        y = torch.einsum("bshk,hkd->bsd", o.to(cdt), params["wo"].to(cdt))
        return x + y.to(x.dtype), cache
    is_self = kv_source is None
    src = h if is_self else kv_source.to(cdt)
    k = torch.einsum("bsd,dhk->bshk", src, params["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", src, params["wv"].to(cdt))
    if is_self and causal:
        q = _rope_or_mrope(cfg, q, positions)
        k = _rope_or_mrope(cfg, k, positions)
    new_cache = None
    if cache is not None:
        o, new_cache = _cached_attention(cfg, q, k, v, cache, chunk_lens, window)
    elif not is_self:
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    elif window:
        o = _windowed_attention(cfg, q, k, v, window)
    else:
        o = _self_attention(cfg, q, k, v, causal)
    y = block_out(torch.einsum, "bshk,hkd->bsd", o.to(cdt), params["wo"].to(cdt))
    return x + y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    H, _ = cfg.padded_gqa()
    specs: Dict[str, Any] = {
        "norm": rmsnorm_specs(d),
        "wkv_a": Param((d, kvr + rd), ("embed", None)),
        "kv_norm": rmsnorm_specs(kvr),
        "wk_b": Param((kvr, H, nd), ("kv_lora", "heads", None)),
        "wv_b": Param((kvr, H, vd), ("kv_lora", "heads", None)),
        "wo": Param((H, vd, d), ("heads", None, "embed")),
    }
    if qr > 0:
        specs["wq_a"] = Param((d, qr), ("embed", "q_lora"))
        specs["q_norm"] = rmsnorm_specs(qr)
        specs["wq_b"] = Param((qr, H, nd + rd), ("q_lora", "heads", None))
    else:
        specs["wq"] = Param((d, H, nd + rd), ("embed", "heads", None))
    return specs


def mla_apply(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    *,
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention over a latent cache: contiguous
    ``{"c_kv" [B,S,kv_lora], "k_pe" [B,S,rope], "len"}`` or paged
    ``{"ckv_pages", "kpe_pages", "block_table", "len"}``.  The branches of
    ``attn_apply``: the ragged chunked prefill (``chunk_lens``, either
    layout), the batched prefill into an empty contiguous cache, the
    paged decode, the per-slot ([B] ``len``) and scalar decode, and the
    no-cache full attention.  The latents are written by the plain,
    sync-free cache scatters (``write_chunk``, ``write_chunk_paged``,
    ``paged_append_plain``: plain jnp in JAX too).  The decodes expand the
    cached latents to per-head K and V (KV == H, so the group is 1) and
    attend through the contiguous decode op on either layout; the
    prefills attend through the plain masked or chunked attention, as JAX
    does.  Caches are written in place."""
    cdt = cfg.compute_dtype
    B, S, _ = x.shape
    nd, kvr = cfg.nope_head_dim, cfg.kv_lora_rank
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    if cfg.q_lora_rank > 0:
        ql = torch.einsum("bsd,dr->bsr", h, params["wq_a"].to(cdt))
        ql = rmsnorm_apply(params["q_norm"], ql, cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", ql, params["wq_b"].to(cdt))
    else:
        q = torch.einsum("bsd,dhk->bshk", h, params["wq"].to(cdt))
    q_nope = q[..., :nd]
    q_pe = apply_rope(q[..., nd:], positions, cfg.rope_theta)
    kv = torch.einsum("bsd,dr->bsr", h, params["wkv_a"].to(cdt))
    c_kv = rmsnorm_apply(params["kv_norm"], kv[..., :kvr], cfg.norm_eps)
    k_pe = apply_rope(kv[..., kvr:][:, :, None, :], positions, cfg.rope_theta)  # [B,S,1,rd]

    new_cache = None
    if cache is not None and S > 1 and chunk_lens is not None:
        # ragged chunked prefill: append the latent chunk at each row's
        # own base offset (either layout), then attend the full cached
        # latents with per-row causal masking
        base = as_rows(cache["len"], B, x.device).to(torch.int32)
        chunk_lens = chunk_lens.to(torch.int32)
        if "ckv_pages" in cache:
            bt = cache["block_table"]
            ckv_pages = write_chunk_paged(cache["ckv_pages"], bt, c_kv, base, chunk_lens)
            kpe_pages = write_chunk_paged(cache["kpe_pages"], bt, k_pe[:, :, 0], base,
                                          chunk_lens)
            new_cache = {"ckv_pages": ckv_pages, "kpe_pages": kpe_pages,
                         "block_table": bt, "len": base + chunk_lens}
            ckv_c, kpe_c = _gather_pages(ckv_pages, bt), _gather_pages(kpe_pages, bt)
        else:
            ckv_c = write_chunk(cache["c_kv"], c_kv, base, chunk_lens)
            kpe_c = write_chunk(cache["k_pe"], k_pe[:, :, 0], base, chunk_lens)
            new_cache = {"c_kv": ckv_c, "k_pe": kpe_c, "len": base + chunk_lens}
        o = _mla_ragged_prefill_attn(cfg, params, q_nope, q_pe, ckv_c, kpe_c,
                                     base, chunk_lens, cdt)
    elif cache is not None and S > 1:
        # batched prefill into an empty cache: write the whole prompt's
        # latents, then the full-attention pass over the fresh latents
        if "ckv_pages" in cache:
            raise NotImplementedError(
                "paged prefill without chunk_lens is not supported: pass "
                "per-row chunk_lens to run the ragged prefill through the "
                "block tables")
        _check_prefill_base(cache["len"])
        if S > cache["c_kv"].shape[1]:
            raise ValueError(f"a {S}-token prefill does not fit a cache of "
                             f"{cache['c_kv'].shape[1]} positions")
        cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_pe"][:, :S] = k_pe[:, :, 0].to(cache["k_pe"].dtype)
        new_cache = {"c_kv": cache["c_kv"], "k_pe": cache["k_pe"], "len": S}
        o = _mla_full_attention(cfg, params, q_nope, q_pe, c_kv, k_pe, cdt)
    elif cache is not None and "ckv_pages" in cache:
        # paged decode: the latents append into the shared pools through
        # the block table, then gather, expand per head and attend
        idx = torch.as_tensor(cache["len"], device=x.device)
        bt = cache["block_table"]
        ckv_pages = paged_append_plain(cache["ckv_pages"], bt, idx, c_kv[:, 0])
        kpe_pages = paged_append_plain(cache["kpe_pages"], bt, idx, k_pe[:, 0, 0])
        new_cache = {"ckv_pages": ckv_pages, "kpe_pages": kpe_pages,
                     "block_table": bt, "len": idx + 1}
        o = _mla_expanded_decode(cfg, params, q_nope, q_pe, _gather_pages(ckv_pages, bt),
                                 _gather_pages(kpe_pages, bt), idx + 1, cdt)
    elif cache is not None:
        idx = torch.as_tensor(cache["len"], device=x.device)
        ckv_c, kpe_c = cache["c_kv"], cache["k_pe"]
        if idx.ndim == 1:  # per-slot decode (continuous batching)
            _slot_append(ckv_c, idx, c_kv[:, 0])
            _slot_append(kpe_c, idx, k_pe[:, 0, 0])
        else:  # one position for every row, clamped as dynamic_update_slice
            pos = idx.to(torch.int64).clamp(0, ckv_c.shape[1] - 1).reshape(1)
            ckv_c.index_copy_(1, pos, c_kv.to(ckv_c.dtype))
            kpe_c.index_copy_(1, pos, k_pe[:, :, 0].to(kpe_c.dtype))
        new_cache = {"c_kv": ckv_c, "k_pe": kpe_c, "len": idx + 1}
        o = _mla_expanded_decode(cfg, params, q_nope, q_pe, ckv_c, kpe_c, idx + 1, cdt)
    else:
        o = _mla_full_attention(cfg, params, q_nope, q_pe, c_kv, k_pe, cdt)
    y = block_out(torch.einsum, "bshk,hkd->bsd", o.to(cdt), params["wo"].to(cdt))
    return x + y.to(x.dtype), new_cache


def _mla_expand(cfg, params, q_nope, q_pe, ckv, kpe, cdt):
    """Latents [B,S,kv_lora] and [B,S,1 or none,rope] -> per-head q, K and
    V [..., H, nope + rope]; V is zero-padded from v_head_dim to the qk
    head dim for the shared attention, and trimmed after it (the padded
    columns come out exact zeros)."""
    B, Sc = ckv.shape[0], ckv.shape[1]
    H = q_nope.shape[2]
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    k_nope = torch.einsum("bsr,rhk->bshk", ckv.to(cdt), params["wk_b"].to(cdt))
    v_full = torch.einsum("bsr,rhk->bshk", ckv.to(cdt), params["wv_b"].to(cdt))
    kpe = kpe.reshape(B, Sc, 1, rd).to(k_nope.dtype).expand(B, Sc, H, rd)
    k_full = torch.cat([k_nope, kpe], dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    v_pad = F.pad(v_full, (0, nd + rd - vd)) if vd < nd + rd else v_full
    return q_full, k_full, v_pad


def _mla_ragged_prefill_attn(cfg, params, q_nope, q_pe, ckv_c, kpe_c, base, clens, cdt):
    """Ragged MLA prefill attention: the full cached latents expanded per
    head, the [B,T] query chunk attending them at per-row offsets
    (padding query rows exact zero) on the masked oracle the prefill
    kernels share."""
    q_full, k_full, v_pad = _mla_expand(cfg, params, q_nope, q_pe, ckv_c, kpe_c, cdt)
    return prefill_attend_ref(q_full, k_full, v_pad, base, clens)[..., :cfg.v_head_dim]


def _mla_expanded_decode(cfg, params, q_nope, q_pe, ckv_c, kpe_c, lens, cdt):
    """MLA single-step decode: the cached latents expanded to full K/V per
    head, through the contiguous decode op (KV == H after the expansion,
    so the group is 1); V padded to the qk head dim, then trimmed."""
    q_full, k_full, v_pad = _mla_expand(cfg, params, q_nope, q_pe, ckv_c, kpe_c, cdt)
    o = ops.decode_attention(q_full[:, 0].contiguous(), k_full, v_pad, lens,
                             impl=cfg.decode_impl)
    return o[:, None].to(q_full.dtype)[..., :cfg.v_head_dim]


def _mla_full_attention(cfg, params, q_nope, q_pe, c_kv, k_pe, cdt):
    """Full causal MLA pass over the in-flight latents (the training
    forward and the batched prefill), on the chunked attention."""
    q_full, k_full, v_pad = _mla_expand(cfg, params, q_nope, q_pe, c_kv, k_pe, cdt)
    return chunked_attention(q_full, k_full, v_pad, causal=True, q_chunk=cfg.q_chunk,
                             kv_chunk=cfg.kv_chunk)[..., :cfg.v_head_dim]


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
    y = block_out(torch.matmul, u, params["w2"].to(cdt))
    return x + y.to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (GShard capacity-based top-k)
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs: Dict[str, Any] = {
        "norm": rmsnorm_specs(d),
        "router": Param((d, E), ("embed", "experts"), init="normal", scale=0.02),
        "w1": Param((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w2": Param((E, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.mlp_act in ("swiglu", "geglu"):
        specs["w3"] = Param((E, d, ff), ("experts", "embed", "expert_mlp"))
    if cfg.moe_dense_residual:
        specs["dense"] = mlp_specs(cfg, cfg.dense_ff or cfg.d_ff)
    return specs


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(c, 4)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, in descending
    order, a tie going to the lower index (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, params, h):
    """h [G,S,d] -> gates [G,S,k] (renormalised over the k), idx [G,S,k],
    and the Switch-style load-balance aux loss."""
    E = cfg.num_experts
    logits = torch.einsum("gsd,de->gse", h, params["router"].to(h.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = top_k(probs, cfg.top_k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], E).float().sum(dim=-2).mean(dim=0) / probs.shape[1]
    aux = (me * ce).sum() * E
    return gates.to(h.dtype), idx, aux


def _positions_in_expert(idx, E, S):
    """idx [G,S,k] -> each choice's slot in its expert (priority by k,
    then token order) [G,S,k], and the expert one-hots [G,S,k,E]."""
    G, _, K = idx.shape
    onehots = F.one_hot(idx, E).to(torch.int32)
    flat = onehots.permute(0, 2, 1, 3).reshape(G, K * S, E)
    pos_flat = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(dim=-1)  # [G,k*S]
    return pos_flat.reshape(G, K, S).permute(0, 2, 1), onehots


def moe_apply(cfg: ModelConfig, params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss).  One routing group per batch row, each
    expert taking at most ``_capacity(S)`` tokens of a group; choices past
    it drop.  ``moe_impl="einsum"`` dispatches and combines by dense
    one-hot einsums, ``"gather"`` by index gathers; both compute the same
    function."""
    cdt = cfg.compute_dtype
    B, S, d = x.shape
    E = cfg.num_experts
    dev = x.device
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    G = B  # one routing group per batch row
    hg = h.reshape(G, S, d)
    C = _capacity(S, cfg)
    gates, idx, aux = _route(cfg, params, hg)
    pos, onehots = _positions_in_expert(idx, E, S)
    keep = ((pos < C) & (gates > 0)).to(cdt)

    if cfg.moe_impl == "einsum":
        # one_hot of a position past C is all zeros, as jax.nn.one_hot
        pos_oh = (pos[..., None] == torch.arange(C, device=dev)).to(cdt)  # [G,S,k,C]
        sel = onehots.to(cdt) * keep[..., None]
        disp = torch.einsum("gske,gskc->gsec", sel, pos_oh)
        expert_in = torch.einsum("gsec,gsd->gecd", disp, hg)
        expert_out = _expert_ffn(cfg, params, expert_in)
        # the combine is gate-weighted per k-choice
        comb = torch.einsum("gske,gskc,gsk->gsec", sel, pos_oh, gates * keep)
        y = torch.einsum("gsec,gecd->gsd", comb, expert_out).reshape(B, S, d)
    else:
        gi = torch.arange(G, device=dev)[:, None, None]
        # token of each (expert, slot), sentinel S; choices past capacity
        # land in a spill column C that is cut off (JAX drops them)
        slot_token = torch.full((G, E, C + 1), S, dtype=torch.int64, device=dev)
        tok = torch.arange(S, device=dev)[None, :, None].expand(idx.shape)
        slot_token[gi.expand(idx.shape), idx, pos.clamp(max=C)] = tok
        h_pad = torch.cat([hg, hg.new_zeros(G, 1, d)], dim=1)
        expert_in = h_pad[gi, slot_token[:, :, :C]]                     # [G,E,C,d]
        expert_out = _expert_ffn(cfg, params, expert_in)
        slot_of_tok = (idx * C + pos.clamp(0, C - 1)).clamp(0, E * C - 1)  # [G,S,k]
        picked = expert_out.reshape(G, E * C, d)[gi, slot_of_tok]       # [G,S,k,d]
        y = (picked * (gates * keep)[..., None]).sum(dim=2).reshape(B, S, d)

    if cfg.moe_dense_residual:
        y = y + (mlp_apply(cfg, params["dense"], x) - x)
    return x + y.to(x.dtype), aux


def _expert_ffn(cfg, params, expert_in):
    """expert_in [G,E,C,d] -> [G,E,C,d]."""
    cdt = cfg.compute_dtype
    u = torch.einsum("gecd,edf->gecf", expert_in, params["w1"].to(cdt))
    if "w3" in params:
        u = _act(cfg.mlp_act, u) * torch.einsum("gecd,edf->gecf", expert_in,
                                                params["w3"].to(cdt))
    else:
        u = _act(cfg.mlp_act, u)
    return torch.einsum("gecf,efd->gecd", u, params["w2"].to(cdt))
