"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend (ViT + merger) is a STUB: input_specs supplies
precomputed patch/token embeddings plus 3-D M-RoPE position ids."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        attention="gqa", mlp_act="swiglu", rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), input_kind="embeds",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        attention="gqa", mlp_act="swiglu",
        mrope_sections=(4, 6, 6), input_kind="embeds",
    )
