"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

Attention-free: runs the long_500k shape (O(1) decode state)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        attention="xlstm", slstm_every=4, conv_width=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=256,
        attention="xlstm", slstm_every=4, conv_width=4,
    )
