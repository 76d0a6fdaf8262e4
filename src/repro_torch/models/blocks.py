"""Transformer building blocks on the paged serving path (mirror of the
GQA subset of ``repro.models.blocks``): RMSNorm, RoPE, the paged branches
of GQA attention, and the SwiGLU/GeGLU/GELU MLP.

Every block is a pair of functions: ``<kind>_specs(cfg)`` declares the
parameters, ``<kind>_apply(cfg, params, x, ...)`` runs the forward.
Activations are ``[batch, seq, ...]``; compute runs in
``cfg.compute_dtype`` while norms and softmax accumulate in fp32.  Paged
caches are updated in place (the JAX blocks return new pools).
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


# ---------------------------------------------------------------------------
# GQA attention block (paged cache only)
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
    chunk_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Causal GQA self-attention over a paged cache ``{"k_pages",
    "v_pages", "block_table", "len"}``.

    With ``S > 1`` and ``chunk_lens`` ([B]) it runs the ragged
    cache-writing prefill: row ``b``'s first ``chunk_lens[b]`` tokens
    append at offset ``cache["len"][b]`` and attend the full cached
    prefix.  With ``S == 1`` each row appends at its own length and
    attends its prefix (continuous-batching decode).  The pools are
    written in place; the returned cache holds the same tensors and the
    new lengths."""
    if cache is None or "k_pages" not in cache:
        raise NotImplementedError(
            "the port serves the paged KV cache only; the contiguous cache "
            "and the no-cache forward are later slices (ROADMAP.md queue 1, "
            "item 6)")
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
    bt = cache["block_table"]
    Bsz = x.shape[0]
    if k.shape[1] > 1:
        if chunk_lens is None:
            raise NotImplementedError(
                "paged prefill without chunk_lens is not supported: pass "
                "per-row chunk_lens to run the ragged cache-writing prefill")
        base = torch.as_tensor(cache["len"], device=x.device).to(
            torch.int32).reshape(-1).expand(Bsz)
        chunk_lens = chunk_lens.to(torch.int32)
        o, k_pages, v_pages = ops.prefill_attention_paged(
            q, k, v, cache["k_pages"], cache["v_pages"], bt, base,
            chunk_lens, impl=cfg.decode_impl)
        new_len = base + chunk_lens
    else:
        idx = cache["len"]
        k_pages = _paged_append(cache["k_pages"], bt, idx, k[:, 0])
        v_pages = _paged_append(cache["v_pages"], bt, idx, v[:, 0])
        new_len = idx + 1
        o = ops.decode_attention_paged(
            q[:, 0], k_pages, v_pages, bt, new_len,
            impl=cfg.decode_impl)[:, None].to(q.dtype)
    new_cache = {"k_pages": k_pages, "v_pages": v_pages, "block_table": bt,
                 "len": new_len}
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
