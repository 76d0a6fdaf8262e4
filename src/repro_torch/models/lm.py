"""Decoder-only token LM (mirror of ``repro.models.lm`` for the dense,
MLA and MoE families): the no-cache forward that training
differentiates, and the serving forward over a KV cache.

Layers follow ``configs.base.block_pattern``: head layers, then a unit
repeated ``reps`` times whose parameters (and caches) are stacked on a
leading ``[reps, ...]`` dim exactly as in the JAX tree, then tail layers.
Each layer is a temporal block (GQA ``attn`` or ``mla``) and a channel
block (``mlp``, or ``moe`` whose auxiliary load-balance losses are summed
over the layers).  Where JAX scans the unit, ``lm_apply`` loops over that
dim (under ``remat``, each repetition is checkpointed, as JAX checkpoints
the scan body); the per-layer cache slices are views, so the in-place
cache writes land in the stacked tensors.  Two cache layouts, as in JAX:
the contiguous slot cache (``lm_cache_specs``: ``[batch, max_len, KV,
D]`` K/V per GQA layer, ``[batch, max_len, rank]`` latents per MLA layer)
and the shared page pool (``lm_paged_cache_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Param, map_tree
from repro_torch.configs.base import ModelConfig, block_pattern
from repro_torch.models import blocks as B

_PORTED_TEMPORAL = ("attn", "mla")


def _check_kinds(cfg: ModelConfig) -> None:
    head, unit, _, tail = block_pattern(cfg)
    kinds = set((*head, *unit, *tail))
    if not {tk for tk, _ in kinds} <= set(_PORTED_TEMPORAL):
        raise NotImplementedError(
            f"the port runs GQA and MLA blocks only, got {sorted(kinds, key=str)} "
            f"for {cfg.name}: windowed and recurrent blocks are a later slice "
            f"(ROADMAP.md queue 1, item 5)")


def _layer_specs(cfg: ModelConfig, tk: str, ck: Optional[str]) -> Dict[str, Any]:
    specs = {"t": B.mla_specs(cfg) if tk == "mla" else B.attn_specs(cfg)}
    if ck == "mlp":
        # in MoE stacks the dense head/tail layers use dense_ff if set
        ff = cfg.dense_ff if (cfg.num_experts > 0 and cfg.dense_ff) else None
        specs["c"] = B.mlp_specs(cfg, ff)
    elif ck == "moe":
        specs["c"] = B.moe_specs(cfg)
    return specs


def _temporal_cache_specs(cfg: ModelConfig, kind: str, batch: int, max_len: int):
    """A GQA layer's contiguous ``[batch, max_len, KV, D]`` K/V rows, or an
    MLA layer's ``[batch, max_len, rank]`` latent rows."""
    cdt = cfg.compute_dtype
    if kind == "mla":
        axes = ("cache_batch", "cache_seq", None)
        return {
            "c_kv": Param((batch, max_len, cfg.kv_lora_rank), axes, dtype=cdt, init="zeros"),
            "k_pe": Param((batch, max_len, cfg.rope_head_dim), axes, dtype=cdt, init="zeros"),
        }
    _, KV = cfg.padded_gqa()
    axes = ("cache_batch", "cache_seq", "cache_heads", None)
    return {
        "k": Param((batch, max_len, KV, cfg.qk_head_dim), axes, dtype=cdt,
                   init="zeros"),
        "v": Param((batch, max_len, KV, cfg.head_dim), axes, dtype=cdt,
                   init="zeros"),
    }


def _temporal_paged_cache_specs(cfg: ModelConfig, kind: str, num_pages: int,
                                page_size: int):
    """One shared page pool per layer (K/V, or the MLA latents); the block
    table lives outside the cache tree (every layer appends at the same
    positions)."""
    cdt = cfg.compute_dtype
    if kind == "mla":
        axes = ("cache_seq", None, None)
        return {
            "ckv_pages": Param((num_pages, page_size, cfg.kv_lora_rank), axes,
                               dtype=cdt, init="zeros"),
            "kpe_pages": Param((num_pages, page_size, cfg.rope_head_dim), axes,
                               dtype=cdt, init="zeros"),
        }
    _, KV = cfg.padded_gqa()
    return {
        "k_pages": Param((num_pages, page_size, KV, cfg.qk_head_dim),
                         ("cache_seq", None, "cache_heads", None),
                         dtype=cdt, init="zeros"),
        "v_pages": Param((num_pages, page_size, KV, cfg.head_dim),
                         ("cache_seq", None, "cache_heads", None),
                         dtype=cdt, init="zeros"),
    }


def _stack(specs: Any, reps: int) -> Any:
    return map_tree(
        lambda p: Param((reps,) + p.shape, ("layers",) + p.axes, p.dtype,
                        p.init, p.scale), specs)


def _layer_tree(cfg: ModelConfig, make) -> Dict[str, Any]:
    head, unit, reps, tail = block_pattern(cfg)
    return {
        "head_layers": {f"h{i}": make(tk, ck) for i, (tk, ck) in enumerate(head)},
        "unit": _stack({f"b{i}": make(tk, ck) for i, (tk, ck) in enumerate(unit)},
                       reps),
        "tail_layers": {f"t{i}": make(tk, ck) for i, (tk, ck) in enumerate(tail)},
    }


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_kinds(cfg)
    specs: Dict[str, Any] = {
        "embed": Param((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                       init="embed"),
        "final_norm": B.rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Param((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    layers = _layer_tree(cfg, lambda tk, ck: _layer_specs(cfg, tk, ck))
    specs.update(head_layers=layers["head_layers"], unit=layers["unit"],
                 tail_layers=layers["tail_layers"])
    return specs


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    _check_kinds(cfg)
    return _layer_tree(
        cfg, lambda tk, ck: _temporal_cache_specs(cfg, tk, batch, max_len))


def lm_paged_cache_specs(cfg: ModelConfig, num_pages: int,
                         page_size: int) -> Dict[str, Any]:
    _check_kinds(cfg)
    return _layer_tree(
        cfg, lambda tk, ck: _temporal_paged_cache_specs(cfg, tk, num_pages, page_size))


def serving_attention_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int, int]]:
    """The attention kernels the serving path of ``cfg`` reaches, each
    with the ``(H, KV, D)`` it gives them: a GQA stack runs both decodes
    and both prefills at (padded H, padded KV, head dim); an MLA stack
    only the contiguous decode, on either layout, at (padded H, padded H,
    nope + rope): its latents are expanded per head, so the group is 1."""
    _check_kinds(cfg)
    H, KV = cfg.padded_gqa()
    if cfg.attention == "mla":
        return {"decode_attention": (H, H, cfg.qk_head_dim)}
    return {kernel: (H, KV, cfg.head_dim) for kernel in (
        "decode_attention", "decode_attention_paged", "prefill_attention",
        "prefill_attention_paged")}


# each layout's cache tensors, by the first one's name (GQA K/V, MLA
# latents; contiguous rows or page pools)
_CACHE_KEYS = {"k": ("k", "v"), "k_pages": ("k_pages", "v_pages"),
               "c_kv": ("c_kv", "k_pe"), "ckv_pages": ("ckv_pages", "kpe_pages")}


def _cache_keys(cache: Dict) -> Tuple[str, str]:
    return next(keys for first, keys in _CACHE_KEYS.items() if first in cache)


def _pack_cache(raw: Dict, length, block_table) -> Dict:
    """Join a layer's cache tensors with the runtime lengths (and, for
    the page pools, the shared block table) into the structure the
    temporal block expects."""
    keys = _cache_keys(raw)
    packed = {key: raw[key] for key in keys}
    if keys[0].endswith("_pages"):
        packed["block_table"] = block_table
    packed["len"] = length
    return packed


def _unpack_cache(cache: Dict) -> Dict:
    return {key: cache[key] for key in _cache_keys(cache)}


def lm_apply(
    cfg: ModelConfig,
    params: Dict[str, Any],
    inputs: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    cache_len=None,
    *,
    block_table: Optional[torch.Tensor] = None,
    chunk_lens: Optional[torch.Tensor] = None,
    remat: bool = True,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns ``(logits [B,S,V], cache, aux_loss)``.

    ``inputs`` are int tokens [B,S].  Without a cache this is the
    training forward: positions default to ``arange(S)``, the attention is
    the causal flash op, and ``remat`` checkpoints each repetition of the
    unit (its activations are recomputed in the backward pass).  With
    ``cache`` and ``cache_len``: a contiguous cache tree
    (``lm_cache_specs``) or, with ``block_table`` ([B, max_pages] int32), a
    paged one (``lm_paged_cache_specs``).  With ``chunk_lens`` ([B]) the
    call is a ragged chunked prefill and ``cache_len`` each row's base
    offset; without it, ``S == 1`` decodes at ``cache_len`` ([B]: each
    row at its own position; scalar: every row at one) and ``S > 1`` is
    the prefill into an empty contiguous cache (``cache_len`` 0).
    Positions default to ``base + arange(S)`` per row (prefill) or
    ``cache_len`` (decode).  The caches are updated in place and the
    returned cache tree holds the same tensors.  ``last_only`` keeps only
    the last position's logits."""
    _check_kinds(cfg)
    if (cache is None) != (cache_len is None):
        raise ValueError("cache and cache_len go together")
    if inputs.ndim != 2:
        raise NotImplementedError(
            "embedding inputs (whisper, qwen2-vl) are a later slice "
            "(ROADMAP.md queue 1, item 5)")
    if remat and cache is None and cfg.remat_policy == "save_block_outputs":
        raise NotImplementedError(
            "remat_policy='save_block_outputs' only matters under sharding: "
            "the distributed slice (ROADMAP.md queue 1, item 6)")
    head, unit, reps, tail = block_pattern(cfg)
    x = params["embed"][inputs].to(cfg.compute_dtype)
    Bsz, S = inputs.shape
    dev = inputs.device
    if cache is not None:
        cache_len = torch.as_tensor(cache_len, device=dev).to(torch.int32)
    if positions is None:
        steps = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        if cache is None:
            positions = steps.expand(Bsz, S)
        elif chunk_lens is not None or S > 1:
            positions = cache_len.reshape(-1).expand(Bsz)[:, None] + steps
        else:
            positions = cache_len.reshape(-1).expand(Bsz)[:, None]

    def run_layer(tk, ck, p, x, c):
        cc = _pack_cache(c, cache_len, block_table) if c is not None else None
        temporal = B.mla_apply if tk == "mla" else B.attn_apply
        x, nc = temporal(cfg, p["t"], x, positions, cc, chunk_lens=chunk_lens)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if ck == "mlp":
            x = B.mlp_apply(cfg, p["c"], x)
        elif ck == "moe":
            x, aux = B.moe_apply(cfg, p["c"], x)
        return x, (_unpack_cache(nc) if nc is not None else None), aux

    def run_unit(x, p_r, c_r):
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for j, (tk, ck) in enumerate(unit):
            x, _, a = run_layer(tk, ck, p_r[f"b{j}"], x,
                                c_r[f"b{j}"] if c_r is not None else None)
            aux = aux + a
        return x, aux

    def layer_cache(group, key):
        return cache[group][key] if cache is not None else None

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_cache: Dict[str, Any] = {"head_layers": {}, "tail_layers": {}}
    for i, (tk, ck) in enumerate(head):
        x, new_cache["head_layers"][f"h{i}"], aux = run_layer(
            tk, ck, params["head_layers"][f"h{i}"], x, layer_cache("head_layers", f"h{i}"))
        aux_total = aux_total + aux
    for r in range(reps):
        p_r = map_tree(lambda t: t[r], params["unit"])
        if cache is not None:  # views: caches written in place
            x, aux = run_unit(x, p_r, map_tree(lambda t: t[r], cache["unit"]))
        elif remat:
            x, aux = checkpoint(run_unit, x, p_r, None, use_reentrant=False)
        else:
            x, aux = run_unit(x, p_r, None)
        aux_total = aux_total + aux
    for i, (tk, ck) in enumerate(tail):
        x, new_cache["tail_layers"][f"t{i}"], aux = run_layer(
            tk, ck, params["tail_layers"][f"t{i}"], x, layer_cache("tail_layers", f"t{i}"))
        aux_total = aux_total + aux

    if last_only:
        x = x[:, -1:]
    x = B.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    head_w = (params["embed"].T if cfg.tie_embeddings
              else params["lm_head"]).to(cfg.compute_dtype)
    logits = x.to(cfg.compute_dtype) @ head_w
    if cache is None:
        return logits, None, aux_total
    new_cache["unit"] = cache["unit"]
    return logits, new_cache, aux_total
