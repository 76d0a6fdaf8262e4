"""Whisper-style encoder-decoder backbone (mirror of ``repro.models.encdec``).

The conv front end is a stub, as in JAX: the caller supplies the frame
embeddings [B, T_enc, d] the two conv layers would produce.  The encoder
is a stack of full (bidirectional) self-attention layers over the frames
plus sinusoidal positions; the decoder is causal self-attention (RoPE,
a contiguous self cache when decoding) x cross-attention to the encoder
output x MLP.  The cross K/V are projected once per sequence
(``precompute_cross_cache``) and live in the decode cache.

The layers' parameters (and caches) are stacked on a leading ``[layers,
...]`` dim exactly as in the JAX tree; where JAX scans that dim, the
port loops over it, and under ``remat`` each layer is checkpointed, as
JAX checkpoints the scan body.  Caches are written in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Param, map_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.lm import _stack


def _sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    """[S, d] fp32: sin then cos of position x ``10000^(-i / (d/2 - 1))``,
    each constant rounded to fp32 as JAX computes it."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    rate = torch.tensor(math.log(10000.0), dtype=torch.float32, device=device) / max(d // 2 - 1, 1)
    ang = pos * torch.exp(-dim * rate)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer_specs(cfg: ModelConfig):
    return {"t": B.attn_specs(cfg), "c": B.mlp_specs(cfg)}


def _dec_layer_specs(cfg: ModelConfig):
    return {"self": B.attn_specs(cfg), "cross": B.attn_specs(cfg), "c": B.mlp_specs(cfg)}


def _num_dec(cfg: ModelConfig) -> int:
    return cfg.num_decoder_layers or cfg.num_layers


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": Param((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="embed"),
        "enc_unit": _stack({"b0": _enc_layer_specs(cfg)}, cfg.num_layers),
        "enc_norm": B.rmsnorm_specs(cfg.d_model),
        "dec_unit": _stack({"b0": _dec_layer_specs(cfg)}, _num_dec(cfg)),
        "final_norm": B.rmsnorm_specs(cfg.d_model),
        "lm_head": Param((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
    }


def encdec_cache_specs(cfg: ModelConfig, batch: int, max_len: int, enc_len: int):
    """Per decoder layer: the self cache ``k``, ``v`` [batch, max_len, KV,
    D] and the cross cache ``xk``, ``xv`` [batch, enc_len, KV, D], in the
    compute dtype, zeros."""
    cdt = cfg.compute_dtype
    axes = ("cache_batch", "cache_seq", "cache_heads", None)
    kv = (cfg.num_kv_heads, cfg.head_dim)
    per_layer = {
        "k": Param((batch, max_len) + kv, axes, dtype=cdt, init="zeros"),
        "v": Param((batch, max_len) + kv, axes, dtype=cdt, init="zeros"),
        "xk": Param((batch, enc_len) + kv, axes, dtype=cdt, init="zeros"),
        "xv": Param((batch, enc_len) + kv, axes, dtype=cdt, init="zeros"),
    }
    return {"dec_unit": _stack({"b0": per_layer}, _num_dec(cfg))}


def _layer(tree, i: int):
    return map_tree(lambda t: t[i], tree)


def _run_layers(body, x, stacked, n: int, remat: bool):
    for i in range(n):
        p = _layer(stacked, i)["b0"]
        x = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
    return x


def encode(cfg: ModelConfig, params, frames: torch.Tensor, *, remat: bool = True):
    """frames: [B, T, d] stubbed conv front-end output -> encoder states
    [B, T, d] in the compute dtype: full attention (the flash op, no
    RoPE) and the MLP per layer, then the encoder norm."""
    x = (frames + _sinusoid(frames.shape[1], cfg.d_model, frames.device)[None]).to(
        cfg.compute_dtype)
    Bsz, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(Bsz, S)

    def body(x, p):
        x, _ = B.attn_apply(cfg, p["t"], x, positions, causal=False)
        return B.mlp_apply(cfg, p["c"], x)

    x = _run_layers(body, x, params["enc_unit"], cfg.num_layers, remat)
    return B.rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def _logits(cfg: ModelConfig, params, x):
    x = B.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x.to(cfg.compute_dtype) @ params["lm_head"].to(cfg.compute_dtype)


def decode_train(cfg: ModelConfig, params, enc_out, tokens, *, remat: bool = True,
                 last_only: bool = False):
    """Teacher-forced decoder pass. tokens: [B, T_dec] -> logits [B, T_dec,
    V] (``last_only``: [B, 1, V]): causal self-attention through the
    flash op, cross-attention to ``enc_out`` through ``chunked_attention``."""
    x = params["embed"][tokens].to(cfg.compute_dtype)
    Bsz, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(Bsz, S)

    def body(x, p):
        x, _ = B.attn_apply(cfg, p["self"], x, positions, causal=True)
        x, _ = B.attn_apply(cfg, p["cross"], x, positions, causal=False, kv_source=enc_out)
        return B.mlp_apply(cfg, p["c"], x)

    x = _run_layers(body, x, params["dec_unit"], _num_dec(cfg), remat)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x)


def precompute_cross_cache(cfg: ModelConfig, params, enc_out):
    """Per-layer cross K/V from the encoder output, stacked as the decode
    cache holds them: ``{"b0": {"xk", "xv"}}``, each [layers, B, T_enc, KV,
    D] in the compute dtype."""
    cdt = cfg.compute_dtype
    src = enc_out.to(cdt)
    cross = params["dec_unit"]["b0"]["cross"]
    n = _num_dec(cfg)
    return {"b0": {
        "xk": torch.stack([torch.einsum("bsd,dhk->bshk", src, cross["wk"][i].to(cdt))
                           for i in range(n)]),
        "xv": torch.stack([torch.einsum("bsd,dhk->bshk", src, cross["wv"][i].to(cdt))
                           for i in range(n)])}}


def decode_step(cfg: ModelConfig, params, tokens, cache, cache_len):
    """Single-token decode. tokens: [B, 1]; ``cache``: ``{"dec_unit": {"b0":
    {"k", "v", "xk", "xv"}}}`` (``encdec_cache_specs``, the cross K/V
    filled by ``precompute_cross_cache``); ``cache_len``: the scalar
    number of tokens already in the self cache (a 0-d device tensor keeps
    the step free of host syncs).  Each layer writes its self K/V at
    ``cache_len`` in place and attends ``cache_len + 1`` positions, then
    attends all of its cross cache; both through the decode op.  Returns
    ``(logits [B, 1, V], cache)`` with the same tensors."""
    x = params["embed"][tokens].to(cfg.compute_dtype)
    Bsz, dev = x.shape[0], x.device
    length = torch.as_tensor(cache_len, device=dev).to(torch.int32)
    if length.ndim != 0:
        raise ValueError("the encoder-decoder decodes every row at one scalar length")
    positions = length.reshape(1, 1).expand(Bsz, 1)
    c = cache["dec_unit"]["b0"]
    xlen = torch.full((), c["xk"].shape[2], dtype=torch.int32, device=dev)
    for i in range(_num_dec(cfg)):
        p = _layer(params["dec_unit"], i)["b0"]
        x, _ = B.attn_apply(cfg, p["self"], x, positions,
                            {"k": c["k"][i], "v": c["v"][i], "len": length}, causal=True)
        x, _ = B.attn_apply(cfg, p["cross"], x, positions,
                            {"xk": c["xk"][i], "xv": c["xv"][i], "xlen": xlen}, causal=False)
        x = B.mlp_apply(cfg, p["c"], x)
    return _logits(cfg, params, x), cache
