"""Decoder-only LM (mirror of ``repro.models.lm``) for the dense, MLA,
MoE, recurrent (xLSTM) and hybrid (RecurrentGemma) families, on tokens
or on embeddings with M-RoPE positions (qwen2-vl): the no-cache forward
that training differentiates, and the serving forward over a cache.

Layers follow ``configs.base.block_pattern``: head layers, then a unit
repeated ``reps`` times whose parameters (and caches) are stacked on a
leading ``[reps, ...]`` dim exactly as in the JAX tree, then tail layers.
Each layer is a temporal block (GQA ``attn``, windowed ``local``,
``mla``, or the recurrent ``rglru``, ``mlstm`` and ``slstm``) and an
optional channel block (``mlp``, or ``moe`` whose auxiliary load-balance
losses are summed over the layers).  Where JAX scans the unit,
``lm_apply`` loops over that dim (under ``remat``, each repetition is
checkpointed, as JAX checkpoints the scan body: everything recomputed in
the backward, or under ``remat_policy="save_block_outputs"`` everything
but the blocks' output projections, saved as JAX's
``save_only_these_names("block_out")`` saves them); the per-layer cache
slices are views, so the in-place cache writes land in the stacked
tensors.  Two cache layouts, as in JAX: the contiguous slot cache
(``lm_cache_specs``: ``[batch, max_len, KV, D]`` K/V per GQA layer, a
ring of ``min(max_len, window)`` slots per local layer, ``[batch,
max_len, rank]`` latents per MLA layer, the recurrent states) and the
shared page pool (``lm_paged_cache_specs``, attention-family blocks
only).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common.params import Param, map_tree
from repro_torch.configs.base import ModelConfig, block_pattern
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R

# the temporal kinds whose state is a recurrence, not a K/V sequence
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def temporal_kinds(cfg: ModelConfig) -> set:
    head, unit, _, tail = block_pattern(cfg)
    return {tk for tk, _ in (*head, *unit, *tail)}


def _temporal_specs(kind: str, cfg: ModelConfig):
    if kind in ("attn", "local"):
        return B.attn_specs(cfg)
    if kind == "mla":
        return B.mla_specs(cfg)
    if kind == "rglru":
        return R.rglru_specs(cfg)
    if kind == "mlstm":
        return R.mlstm_specs(cfg)
    if kind == "slstm":
        return R.slstm_specs(cfg)
    raise ValueError(kind)


def _temporal_apply(kind: str, cfg, params, x, positions, cache, chunk_lens=None):
    if kind == "attn":
        return B.attn_apply(cfg, params, x, positions, cache, chunk_lens=chunk_lens)
    if kind == "local":
        if chunk_lens is not None:
            raise NotImplementedError(
                "chunked prefill does not support windowed (local) "
                "attention: ring cache writes need the full prompt")
        return B.attn_apply(cfg, params, x, positions, cache, window=cfg.window)
    if kind == "mla":
        return B.mla_apply(cfg, params, x, positions, cache, chunk_lens=chunk_lens)
    if chunk_lens is not None:
        raise NotImplementedError(
            f"chunked prefill supports attention-family blocks only, "
            f"got {kind!r}")
    if kind == "rglru":
        return R.rglru_block_apply(cfg, params, x, cache)
    if kind == "mlstm":
        return R.mlstm_block_apply(cfg, params, x, cache)
    if kind == "slstm":
        return R.slstm_block_apply(cfg, params, x, cache)
    raise ValueError(kind)


def _layer_specs(cfg: ModelConfig, tk: str, ck: Optional[str]) -> Dict[str, Any]:
    specs = {"t": _temporal_specs(tk, cfg)}
    if ck == "mlp":
        # in MoE stacks the dense head/tail layers use dense_ff if set
        ff = cfg.dense_ff if (cfg.num_experts > 0 and cfg.dense_ff) else None
        specs["c"] = B.mlp_specs(cfg, ff)
    elif ck == "moe":
        specs["c"] = B.moe_specs(cfg)
    return specs


def _temporal_cache_specs(cfg: ModelConfig, kind: str, batch: int, max_len: int):
    """A layer's contiguous cache: a GQA layer's ``[batch, max_len, KV,
    D]`` K/V rows (a local layer's ring of ``min(max_len, window)``
    slots), an MLA layer's ``[batch, max_len, rank]`` latent rows, or a
    recurrent layer's state (the conv inputs in the compute dtype, the
    recurrences in fp32; every one zeros, mLSTM's ``m`` too)."""
    cdt, f32 = cfg.compute_dtype, torch.float32
    if kind in ("attn", "local"):
        _, KV = cfg.padded_gqa()
        slots = min(max_len, cfg.window) if (kind == "local" and cfg.window) else max_len
        axes = ("cache_batch", "cache_seq", "cache_heads", None)
        return {
            "k": Param((batch, slots, KV, cfg.qk_head_dim), axes, dtype=cdt, init="zeros"),
            "v": Param((batch, slots, KV, cfg.head_dim), axes, dtype=cdt, init="zeros"),
        }
    if kind == "mla":
        axes = ("cache_batch", "cache_seq", None)
        return {
            "c_kv": Param((batch, max_len, cfg.kv_lora_rank), axes, dtype=cdt, init="zeros"),
            "k_pe": Param((batch, max_len, cfg.rope_head_dim), axes, dtype=cdt, init="zeros"),
        }
    if kind == "rglru":
        r, w = cfg.rnn_width, cfg.conv_width
        return {
            "conv": Param((batch, w - 1, r), ("cache_batch", None, "rnn"), dtype=cdt,
                          init="zeros"),
            "h": Param((batch, r), ("cache_batch", "rnn"), dtype=f32, init="zeros"),
        }
    if kind == "mlstm":
        m = 2 * cfg.d_model
        nh = cfg.num_heads
        dh = m // nh
        return {
            "conv": Param((batch, cfg.conv_width - 1, m), ("cache_batch", None, "rnn"),
                          dtype=cdt, init="zeros"),
            "C": Param((batch, nh, dh, dh), ("cache_batch", None, None, None), dtype=f32,
                       init="zeros"),
            "n": Param((batch, nh, dh), ("cache_batch", None, None), dtype=f32,
                       init="zeros"),
            "m": Param((batch, nh), ("cache_batch", None), dtype=f32, init="zeros"),
        }
    if kind == "slstm":
        d = cfg.d_model
        return {name: Param((batch, d), ("cache_batch", "rnn"), dtype=f32, init="zeros")
                for name in ("c", "n", "h", "m")}
    raise ValueError(kind)


def _temporal_paged_cache_specs(cfg: ModelConfig, kind: str, num_pages: int,
                                page_size: int):
    """One shared page pool per layer (K/V, or the MLA latents); the block
    table lives outside the cache tree (every layer appends at the same
    positions).  Full-attention kinds only, as in JAX: a recurrent state
    has no sequence axis to page, and a ring would need page recycling."""
    cdt = cfg.compute_dtype
    if kind == "mla":
        axes = ("cache_seq", None, None)
        return {
            "ckv_pages": Param((num_pages, page_size, cfg.kv_lora_rank), axes,
                               dtype=cdt, init="zeros"),
            "kpe_pages": Param((num_pages, page_size, cfg.rope_head_dim), axes,
                               dtype=cdt, init="zeros"),
        }
    if kind != "attn":
        raise NotImplementedError(
            f"paged KV cache supports full-attention blocks only, got {kind!r}")
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
    return _layer_tree(
        cfg, lambda tk, ck: _temporal_cache_specs(cfg, tk, batch, max_len))


def lm_paged_cache_specs(cfg: ModelConfig, num_pages: int,
                         page_size: int) -> Dict[str, Any]:
    return _layer_tree(
        cfg, lambda tk, ck: _temporal_paged_cache_specs(cfg, tk, num_pages, page_size))


def serving_attention_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int, int]]:
    """The attention kernels the serving path of ``cfg`` reaches, each
    with the ``(H, KV, D)`` it gives them: a GQA stack runs both decodes
    and both prefills at (padded H, padded KV, head dim); an MLA stack
    only the contiguous decode, on either layout, at (padded H, padded H,
    nope + rope): its latents are expanded per head, so the group is 1.
    A stack with recurrent or windowed blocks is served by the decode
    step alone, over the contiguous cache (the engine refuses it, as
    JAX's does): its local layers' ring decode runs the contiguous decode
    at (padded H, padded KV, head dim), and a stack without attention
    runs no kernel.  The encoder-decoder (whisper) and the embedding-input
    M-RoPE stack (qwen2-vl) are decoded by their decode steps alone, as
    JAX's engine refuses them: the contiguous decode at (padded H, padded
    KV, head dim), whisper's over its self and its cross cache."""
    H, KV = cfg.padded_gqa()
    if cfg.is_encoder_decoder or cfg.input_kind != "tokens" or cfg.mrope_sections:
        return {"decode_attention": (H, KV, cfg.head_dim)}
    kinds = temporal_kinds(cfg)
    if kinds & {"local", *RECURRENT_KINDS}:
        return ({"decode_attention": (H, KV, cfg.head_dim)}
                if kinds & {"attn", "local"} else {})
    if cfg.attention == "mla":
        return {"decode_attention": (H, H, cfg.qk_head_dim)}
    return {kernel: (H, KV, cfg.head_dim) for kernel in (
        "decode_attention", "decode_attention_paged", "prefill_attention",
        "prefill_attention_paged")}


def _pack_cache(kind: str, raw: Dict, length, block_table) -> Dict:
    """Join a layer's cache tensors with the runtime lengths (and, for
    the page pools, the shared block table) into the structure the
    temporal block expects; a recurrent state needs neither."""
    if kind in ("attn", "local"):
        if "k_pages" in raw:
            return {"k_pages": raw["k_pages"], "v_pages": raw["v_pages"],
                    "block_table": block_table, "len": length}
        return {"k": raw["k"], "v": raw["v"], "len": length}
    if kind == "mla":
        if "ckv_pages" in raw:
            return {"ckv_pages": raw["ckv_pages"], "kpe_pages": raw["kpe_pages"],
                    "block_table": block_table, "len": length}
        return {"c_kv": raw["c_kv"], "k_pe": raw["k_pe"], "len": length}
    if kind == "rglru":
        return {"conv": raw["conv"], "h": raw["h"]}
    if kind == "mlstm":
        return {"conv": raw["conv"], "state": (raw["C"], raw["n"], raw["m"])}
    if kind == "slstm":
        return {"state": (raw["c"], raw["n"], raw["h"], raw["m"])}
    raise ValueError(kind)


def _unpack_cache(kind: str, cache: Dict) -> Dict:
    """A layer's cache tensors (written in place by its block) in the
    declared tree's structure."""
    if kind in ("attn", "local"):
        if "k_pages" in cache:
            return {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"]}
        return {"k": cache["k"], "v": cache["v"]}
    if kind == "mla":
        if "ckv_pages" in cache:
            return {"ckv_pages": cache["ckv_pages"], "kpe_pages": cache["kpe_pages"]}
        return {"c_kv": cache["c_kv"], "k_pe": cache["k_pe"]}
    if kind == "rglru":
        return {"conv": cache["conv"], "h": cache["h"]}
    if kind == "mlstm":
        C, n, m = cache["state"]
        return {"conv": cache["conv"], "C": C, "n": n, "m": m}
    if kind == "slstm":
        c, n, h, m = cache["state"]
        return {"c": c, "n": n, "h": h, "m": m}
    raise ValueError(kind)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_block_outputs(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy: save the matmuls run inside
    ``blocks.block_out``, recompute every other op."""
    if op in _MATMULS and B.naming_block_out():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_unit(cfg: ModelConfig, run_unit):
    """The unit checkpoint's function and ``context_fn`` for
    ``cfg.remat_policy``: ``"save_block_outputs"`` names the blocks'
    output projections inside the unit and keeps them; any other policy
    (``"full"``) recomputes everything, as in JAX."""
    if cfg.remat_policy == "save_block_outputs":
        return B.selecting_block_outputs(run_unit), functools.partial(
            create_selective_checkpoint_contexts, _save_block_outputs)
    return run_unit, torch.utils.checkpoint.noop_context_fn


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

    ``inputs`` are int tokens [B,S] or embeddings [B,S,d] (the stubbed
    vision or audio front end's output, cast to the compute dtype).
    ``positions`` are [B,S], or [B,S,3] (t, h, w) for M-RoPE (a config with
    ``mrope_sections`` needs them; a plain RoPE config reads their t).
    Without a cache this is the
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
    returned cache tree holds the same tensors.  A stack with recurrent
    blocks takes a cache one token at a time (``S == 1``): JAX's cached
    recurrent step reads only the first of ``S > 1`` tokens and broadcasts
    its output, so the port refuses that call before writing anything.
    ``last_only`` keeps only the last position's logits."""
    if (cache is None) != (cache_len is None):
        raise ValueError("cache and cache_len go together")
    head, unit, reps, tail = block_pattern(cfg)
    Bsz, S = inputs.shape[:2]
    if cache is not None and S > 1 and chunk_lens is None:
        recurrent = sorted(temporal_kinds(cfg) & set(RECURRENT_KINDS))
        if recurrent:
            raise NotImplementedError(
                f"a cache over recurrent blocks ({', '.join(recurrent)}) is "
                f"filled one token at a time (S == 1), got S={S}: the "
                f"reference's cached recurrent step reads only the first "
                f"token and broadcasts its output (ROADMAP.md queue 3)")
    x = (params["embed"][inputs] if inputs.ndim == 2 else inputs).to(cfg.compute_dtype)
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
        cc = _pack_cache(tk, c, cache_len, block_table) if c is not None else None
        x, nc = _temporal_apply(tk, cfg, p["t"], x, positions, cc, chunk_lens)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if ck == "mlp":
            x = B.mlp_apply(cfg, p["c"], x)
        elif ck == "moe":
            x, aux = B.moe_apply(cfg, p["c"], x)
        return x, (_unpack_cache(tk, nc) if nc is not None else None), aux

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
            fn, context_fn = _remat_unit(cfg, run_unit)
            x, aux = checkpoint(fn, x, p_r, None, use_reentrant=False,
                                context_fn=context_fn)
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
