"""Meta-tensor stand-ins and partition specs for every (arch x shape) cell
(mirror of ``repro.launch.specs``).

``input_specs`` returns ``(step_kind, args, in_specs, out_specs)``:
``args`` is the tuple passed to the step function, as tensors on the meta
device (shapes and dtypes, no memory), and the specs are
``distributed.sharding``'s tuples, the entries of JAX's ``PartitionSpec``
(``()`` for a replicated scalar).  A decode step's ``cache_len`` is a 0-d
int32 meta tensor, as JAX's is a 0-d int32 ``ShapeDtypeStruct``: no
path a dry run drives reads it to the host.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.params import abstract_params
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed.sharding import merge_rules, param_specs_tree, spec_for
from repro_torch.train.state import abstract_train_state, cache_specs, train_state_specs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, B: int, S: int, *, labels: bool):
    """(meta batch dict, logical-axes dict)."""
    batch: Dict[str, Any] = {}
    axes: Dict[str, Tuple] = {}
    if cfg.is_encoder_decoder:
        dec = max(S // cfg.dec_len_ratio, 8)
        batch["frames"] = _meta((B, S, cfg.d_model), cfg.compute_dtype)
        axes["frames"] = ("act_batch", None, None)
        batch["tokens"] = _meta((B, dec), torch.int32)
        axes["tokens"] = ("act_batch", None)
        if labels:
            batch["labels"] = _meta((B, dec), torch.int32)
            axes["labels"] = ("act_batch", None)
        return batch, axes
    if cfg.input_kind == "embeds":
        batch["embeds"] = _meta((B, S, cfg.d_model), cfg.compute_dtype)
        axes["embeds"] = ("act_batch", None, None)
        if cfg.mrope_sections:
            batch["positions"] = _meta((B, S, 3), torch.int32)
            axes["positions"] = ("act_batch", None, None)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
        axes["tokens"] = ("act_batch", None)
    if labels:
        batch["labels"] = _meta((B, S), torch.int32)
        axes["labels"] = ("act_batch", None)
    return batch, axes


def _params_only(cfg: ModelConfig, run_cfg: RunConfig):
    return train_state_specs(cfg, run_cfg)["params"]


def input_specs(cfg: ModelConfig, shape: ShapeConfig, run_cfg: RunConfig, mesh,
                rules=None):
    """-> (kind, args, in_specs, out_specs) of the cell's step on ``mesh``
    (anything with a ``shape`` dict of axis sizes).  A config with
    ``fsdp_over_pod`` shards its ``embed`` dims over ("pod", "data")."""
    overrides = dict(rules) if rules else {}
    if cfg.fsdp_over_pod:
        overrides["embed"] = ("pod", "data")
    rules = merge_rules(overrides)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state = abstract_train_state(cfg, run_cfg)
        state_specs = param_specs_tree(train_state_specs(cfg, run_cfg), mesh, rules)
        batch, axes = _batch_specs(cfg, B, S, labels=True)
        batch_specs = {k: spec_for(axes[k], v.shape, mesh, rules) for k, v in batch.items()}
        out_specs = (state_specs, {"loss": (), "grad_norm": ()})
        return "train", (state, batch), (state_specs, batch_specs), out_specs
    if shape.kind == "prefill":
        params = abstract_params(_params_only(cfg, run_cfg))
        p_specs = param_specs_tree(_params_only(cfg, run_cfg), mesh, rules)
        batch, axes = _batch_specs(cfg, B, S, labels=False)
        batch_specs = {k: spec_for(axes[k], v.shape, mesh, rules) for k, v in batch.items()}
        out_specs = spec_for(("act_batch", "act_vocab"), (B, cfg.padded_vocab), mesh, rules)
        return "prefill", (params, batch), (p_specs, batch_specs), out_specs
    if shape.kind == "decode":
        params = abstract_params(_params_only(cfg, run_cfg))
        p_specs = param_specs_tree(_params_only(cfg, run_cfg), mesh, rules)
        cspecs = cache_specs(cfg, B, S)
        cache = abstract_params(cspecs)
        c_specs = param_specs_tree(cspecs, mesh, rules)
        tokens = _meta((B, 1), torch.int32)
        t_spec = spec_for(("act_batch", None), (B, 1), mesh, rules)
        clen = _meta((), torch.int32)
        out_specs = (
            spec_for(("act_batch",), (B,), mesh, rules),
            spec_for(("act_batch", None, "act_vocab"), (B, 1, cfg.padded_vocab), mesh, rules),
            c_specs,
        )
        return "decode", (params, tokens, cache, clen), (p_specs, t_spec, c_specs, ()), out_specs
    raise ValueError(shape.kind)
