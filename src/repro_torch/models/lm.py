"""Decoder-only token LM (mirror of the dense GQA subset of
``repro.models.lm``): the no-cache forward that training differentiates,
and the serving forward over a KV cache.

Layers follow ``configs.base.block_pattern``: head layers, then a unit
repeated ``reps`` times whose parameters (and caches) are stacked on a
leading ``[reps, ...]`` dim exactly as in the JAX tree, then tail layers.
Where JAX scans the unit, ``lm_apply`` loops over that dim (under
``remat``, each repetition is checkpointed, as JAX checkpoints the scan
body); the per-layer cache slices are views, so the in-place cache
writes land in the stacked tensors.  Two cache layouts, as in JAX: the
contiguous slot cache (``lm_cache_specs``, ``[batch, max_len, KV, D]``
per layer) and the shared page pool (``lm_paged_cache_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Param, map_tree
from repro_torch.configs.base import ModelConfig, block_pattern
from repro_torch.models import blocks as B

_PORTED_KINDS = (("attn", "mlp"),)


def _check_kinds(cfg: ModelConfig) -> None:
    head, unit, _, tail = block_pattern(cfg)
    kinds = set((*head, *unit, *tail))
    if not kinds <= set(_PORTED_KINDS):
        mla_moe = any(k in ("mla", "moe") for kind in kinds for k in kind)
        what, item = (("MLA and MoE", 3) if mla_moe
                      else ("windowed and recurrent", 5))
        raise NotImplementedError(
            f"the port runs dense GQA blocks only, got {sorted(kinds, key=str)} "
            f"for {cfg.name}: {what} blocks are a later slice (ROADMAP.md "
            f"queue 1, item {item})")


def _temporal_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """One contiguous ``[batch, max_len, KV, D]`` row pair per layer."""
    _, KV = cfg.padded_gqa()
    cdt = cfg.compute_dtype
    axes = ("cache_batch", "cache_seq", "cache_heads", None)
    return {
        "k": Param((batch, max_len, KV, cfg.qk_head_dim), axes, dtype=cdt,
                   init="zeros"),
        "v": Param((batch, max_len, KV, cfg.head_dim), axes, dtype=cdt,
                   init="zeros"),
    }


def _temporal_paged_cache_specs(cfg: ModelConfig, num_pages: int,
                                page_size: int):
    """One shared page pool per layer; the block table lives outside the
    cache tree (every layer appends at the same positions)."""
    _, KV = cfg.padded_gqa()
    cdt = cfg.compute_dtype
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
    layers = _layer_tree(
        cfg, lambda tk, ck: {"t": B.attn_specs(cfg), "c": B.mlp_specs(cfg)})
    specs.update(head_layers=layers["head_layers"], unit=layers["unit"],
                 tail_layers=layers["tail_layers"])
    return specs


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    _check_kinds(cfg)
    return _layer_tree(
        cfg, lambda tk, ck: _temporal_cache_specs(cfg, batch, max_len))


def lm_paged_cache_specs(cfg: ModelConfig, num_pages: int,
                         page_size: int) -> Dict[str, Any]:
    _check_kinds(cfg)
    return _layer_tree(
        cfg, lambda tk, ck: _temporal_paged_cache_specs(cfg, num_pages, page_size))


def _pack_cache(raw: Dict, length, block_table) -> Dict:
    """Join a layer's cache tensors with the runtime lengths (and, for
    the page pools, the shared block table) into the structure
    ``attn_apply`` expects."""
    if "k_pages" in raw:
        return {"k_pages": raw["k_pages"], "v_pages": raw["v_pages"],
                "block_table": block_table, "len": length}
    return {"k": raw["k"], "v": raw["v"], "len": length}


def _unpack_cache(cache: Dict) -> Dict:
    if "k_pages" in cache:
        return {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"]}
    return {"k": cache["k"], "v": cache["v"]}


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

    def run_layer(ck, p, x, c):
        cc = _pack_cache(c, cache_len, block_table) if c is not None else None
        x, nc = B.attn_apply(cfg, p["t"], x, positions, cc,
                             chunk_lens=chunk_lens)
        if ck == "mlp":
            x = B.mlp_apply(cfg, p["c"], x)
        return x, (_unpack_cache(nc) if nc is not None else None)

    def run_unit(x, p_r, c_r):
        for j, (_, ck) in enumerate(unit):
            x, _ = run_layer(ck, p_r[f"b{j}"], x,
                             c_r[f"b{j}"] if c_r is not None else None)
        return x

    def layer_cache(group, key):
        return cache[group][key] if cache is not None else None

    new_cache: Dict[str, Any] = {"head_layers": {}, "tail_layers": {}}
    for i, (_, ck) in enumerate(head):
        x, new_cache["head_layers"][f"h{i}"] = run_layer(
            ck, params["head_layers"][f"h{i}"], x, layer_cache("head_layers", f"h{i}"))
    for r in range(reps):
        p_r = map_tree(lambda t: t[r], params["unit"])
        if cache is not None:  # views: caches written in place
            x = run_unit(x, p_r, map_tree(lambda t: t[r], cache["unit"]))
        elif remat:
            x = checkpoint(run_unit, x, p_r, None, use_reentrant=False)
        else:
            x = run_unit(x, p_r, None)
    for i, (_, ck) in enumerate(tail):
        x, new_cache["tail_layers"][f"t{i}"] = run_layer(
            ck, params["tail_layers"][f"t{i}"], x, layer_cache("tail_layers", f"t{i}"))

    if last_only:
        x = x[:, -1:]
    x = B.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    head_w = (params["embed"].T if cfg.tie_embeddings
              else params["lm_head"]).to(cfg.compute_dtype)
    logits = x.to(cfg.compute_dtype) @ head_w
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cache is None:
        return logits, None, aux
    new_cache["unit"] = cache["unit"]
    return logits, new_cache, aux
