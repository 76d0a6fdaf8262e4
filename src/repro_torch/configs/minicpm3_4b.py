"""minicpm3-4b [dense] — MLA (multi-head latent attention)
[hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        attention="mla", mlp_act="swiglu", rope_theta=10_000.0,
        q_lora_rank=768, kv_lora_rank=256,
        nope_head_dim=64, rope_head_dim=32, v_head_dim=64, head_dim=64,
        head_pad_multiple=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256,
        attention="mla", mlp_act="swiglu",
        q_lora_rank=48, kv_lora_rank=32,
        nope_head_dim=16, rope_head_dim=8, v_head_dim=16, head_dim=16,
    )
