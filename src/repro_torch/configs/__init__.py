"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (  # noqa: F401
    DECODE_IMPLS,
    SHAPES,
    SMOKE_SHAPES,
    ModelConfig,
    RunConfig,
    ShapeConfig,
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


def default_run_config(arch: str, shape: str) -> RunConfig:
    """Per-cell runtime knobs, those of the JAX package (sized there so its
    dry-run fits 16 GB of device memory per chip)."""
    micro = 1
    optimizer, opt_dtype = "adamw", torch.float32
    if shape == "train_4k":
        micro = {
            "qwen2-vl-72b": 8, "arctic-480b": 16, "phi3-medium-14b": 8,
            "recurrentgemma-9b": 8, "minicpm3-4b": 8, "phi3-mini-3.8b": 4,
            "moonshot-v1-16b-a3b": 8, "whisper-medium": 2,
            "tinyllama-1.1b": 2, "xlstm-125m": 4,
        }.get(arch, 1)
    grad_clip = 1.0
    if arch == "arctic-480b":
        # factored Adafactor states; its RMS update clipping replaces the
        # global-norm clip
        optimizer = "adafactor"
        grad_clip = 0.0
    if arch == "qwen2-vl-72b":
        opt_dtype = torch.bfloat16
    return RunConfig(num_microbatches=micro, optimizer=optimizer,
                     opt_state_dtype=opt_dtype, grad_clip=grad_clip)
