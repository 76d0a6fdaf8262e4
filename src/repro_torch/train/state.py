"""Model parameter specs (mirror of ``repro.train.state.model_specs``);
optimizer and train-state trees are the training slice."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import lm_specs


def model_specs(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder models are a later slice (ROADMAP.md queue 1, "
            "item 9)")
    return lm_specs(cfg)
