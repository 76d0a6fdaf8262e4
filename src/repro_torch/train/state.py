"""Model, cache and train-state specs (mirror of ``repro.train.state``),
the concrete train state and its sharding specs."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.params import Param, abstract_params, init_params, map_tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import param_specs_tree
from repro_torch.models import encdec
from repro_torch.models.lm import lm_cache_specs, lm_specs
from repro_torch.train.optimizer import opt_specs

# the encoder positions of whisper's cross cache (30 s of audio)
ENC_LEN = 1500


def model_specs(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return encdec.encdec_specs(cfg)
    return lm_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The contiguous slot cache of ``batch`` rows of ``max_len``; an
    encoder-decoder's decoder self cache is ``max_len`` and its cross
    cache ``ENC_LEN`` positions whatever ``max_len`` is, as in JAX."""
    if cfg.is_encoder_decoder:
        return encdec.encdec_cache_specs(cfg, batch, max_len, enc_len=ENC_LEN)
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


def abstract_train_state(cfg: ModelConfig, run_cfg: RunConfig) -> Dict[str, Any]:
    """The train state as meta tensors: the dry run's argument."""
    return abstract_params(train_state_specs(cfg, run_cfg))


def state_shardings(cfg: ModelConfig, run_cfg: RunConfig, mesh, rules=None):
    """The train state's partition specs on ``mesh`` (anything with a
    ``shape`` dict of axis sizes) under the default rules and ``rules``."""
    return param_specs_tree(train_state_specs(cfg, run_cfg), mesh, rules)
