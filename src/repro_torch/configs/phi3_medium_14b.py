"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128,
        attention="gqa", mlp_act="swiglu", rope_theta=10_000.0,
        head_pad_multiple=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        attention="gqa", mlp_act="swiglu",
    )
