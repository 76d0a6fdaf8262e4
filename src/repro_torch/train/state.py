"""Model, cache and train-state specs (mirror of ``repro.train.state``),
and the concrete train state."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.params import Param, init_params, map_tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.lm import lm_cache_specs, lm_specs
from repro_torch.train.optimizer import opt_specs


def model_specs(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder models are a later slice (ROADMAP.md queue 1, "
            "item 9)")
    return lm_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The contiguous slot cache of ``batch`` rows of ``max_len``."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder caches are a later slice (ROADMAP.md queue 1, "
            "item 9)")
    return lm_cache_specs(cfg, batch, max_len)


def train_state_specs(cfg: ModelConfig, run_cfg: RunConfig) -> Dict[str, Any]:
    """``{"params", "opt", "step"}``: parameters stored in
    ``cfg.param_dtype``, the optimizer's state, and a 0-d int32 step."""
    p = map_tree(lambda q: Param(q.shape, q.axes, cfg.param_dtype, q.init,
                                 q.scale), model_specs(cfg))
    return {
        "params": p,
        "opt": opt_specs(p, run_cfg),
        "step": Param((), (), torch.int32, init="zeros"),
    }


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     run_cfg: RunConfig, device="cuda") -> Dict[str, Any]:
    """A fresh train state on ``device`` (the card unless the caller asks
    for the CPU), its random leaves drawn from ``generator``, which lives
    on that device."""
    return init_params(generator, train_state_specs(cfg, run_cfg), device)
