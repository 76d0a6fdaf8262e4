"""Model parameter and serving-cache specs (mirror of
``repro.train.state.model_specs`` and ``cache_specs``); optimizer and
train-state trees are the training slice."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import lm_cache_specs, lm_specs


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
