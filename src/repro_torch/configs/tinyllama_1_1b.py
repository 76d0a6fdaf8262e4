"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        d_ff=5632, vocab_size=32000, head_dim=64,
        attention="gqa", mlp_act="swiglu", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=16,
        attention="gqa", mlp_act="swiglu",
    )
