"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163840, head_dim=128,
        attention="gqa", mlp_act="swiglu", rope_theta=50_000.0,
        num_experts=64, top_k=6, capacity_factor=1.25,
        first_k_dense=1, dense_ff=11264,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=32,
        attention="gqa", mlp_act="swiglu",
        num_experts=8, top_k=2, capacity_factor=2.0,
        first_k_dense=1, dense_ff=256,
    )
