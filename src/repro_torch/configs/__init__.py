"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    DECODE_IMPLS,
    ModelConfig,
    RunConfig,
    block_pattern,
)

ARCHS = {
    "phi3-medium-14b": "phi3_medium_14b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "minicpm3-4b": "minicpm3_4b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b": "arctic_480b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.smoke_config() if smoke else mod.config()
