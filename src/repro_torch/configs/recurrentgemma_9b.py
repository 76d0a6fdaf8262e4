"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427].  Sub-quadratic: runs the long_500k shape."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        attention="rglru-hybrid", rglru_pattern=3, window=2048,
        rnn_width=4096, conv_width=4, mlp_act="geglu",
        remat_policy="save_block_outputs",  # §Perf H12: -7.4% collective
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="rglru-hybrid", rglru_pattern=3, window=16,
        rnn_width=64, conv_width=4, mlp_act="geglu",
    )
