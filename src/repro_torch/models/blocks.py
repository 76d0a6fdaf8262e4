"""Transformer building blocks on the serving path (mirror of the GQA
subset of ``repro.models.blocks``): RMSNorm, RoPE, the cache branches of
GQA attention (paged and contiguous), and the SwiGLU/GeGLU/GELU MLP.

Every block is a pair of functions: ``<kind>_specs(cfg)`` declares the
parameters, ``<kind>_apply(cfg, params, x, ...)`` runs the forward.
Activations are ``[batch, seq, ...]``; compute runs in
``cfg.compute_dtype`` while norms and softmax accumulate in fp32.  Caches
are updated in place (the JAX blocks return new ones).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
# Paged cache scatter
# ---------------------------------------------------------------------------


def _paged_append(pages: torch.Tensor, block_table: torch.Tensor,
                  idx: torch.Tensor, row_vals: torch.Tensor) -> torch.Tensor:
    """Scatter one new position per row into the shared page pool, in
    place.  ``idx`` [B] is each row's append position; unallocated /
    out-of-range logical pages hit the sentinel (>= num_pages) and the
    write drops."""
    num_pages, page_size = pages.shape[0], pages.shape[1]
    max_pages = block_table.shape[1]
    idx = idx.to(torch.int64)
    rows = torch.arange(block_table.shape[0], device=pages.device)
    lp = idx // page_size
    phys = torch.where(
        lp < max_pages,
        block_table.to(torch.int64)[rows, lp.clamp(max=max_pages - 1)],
        num_pages)
    keep = (phys >= 0) & (phys < num_pages)
    pages[phys[keep], (idx % page_size)[keep]] = row_vals[keep].to(pages.dtype)
    return pages


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


def attn_apply(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict],
    *,
    window: int = 0,
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Causal GQA self-attention over a KV cache: paged ``{"k_pages",
    "v_pages", "block_table", "len"}`` or contiguous ``{"k", "v", "len"}``
    (``[B, S, KV, D]`` rows).

    With ``S > 1`` and ``chunk_lens`` ([B]) it runs the ragged
    cache-writing prefill: row ``b``'s first ``chunk_lens[b]`` tokens
    append at offset ``cache["len"][b]`` and attend the full cached
    prefix.  With ``S == 1`` each row appends at its length and attends
    its prefix: a [B] ``len`` is continuous-batching decode (a contiguous
    row whose length is negative or past its cache drops its write), a
    scalar ``len`` decodes every row at one position (the contiguous
    write clamps to the last position, as ``dynamic_update_slice``
    does).  Caches are written in place; the returned cache holds the
    same tensors and the new lengths."""
    if cache is None:
        raise NotImplementedError(
            "the no-cache forward (chunked_attention) is the training slice "
            "(ROADMAP.md queue 1, item 8)")
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
    Bsz = x.shape[0]
    length = torch.as_tensor(cache["len"], device=x.device)
    paged = "k_pages" in cache
    if k.shape[1] > 1:
        if chunk_lens is None:
            raise NotImplementedError(
                "prefill without chunk_lens (the empty-cache flash pass) is "
                "the training slice (ROADMAP.md queue 1, item 8): pass "
                "per-row chunk_lens to run the ragged cache-writing prefill")
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
        k_c = _paged_append(cache["k_pages"], cache["block_table"], length, k[:, 0])
        v_c = _paged_append(cache["v_pages"], cache["block_table"], length, v[:, 0])
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
        new_cache = {"k_pages": k_c, "v_pages": v_c,
                     "block_table": cache["block_table"], "len": new_len}
    else:
        new_cache = {"k": k_c, "v": v_c, "len": new_len}
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
