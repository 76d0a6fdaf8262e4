"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
import torch
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000, head_dim=128,
        attention="gqa", mlp_act="swiglu", rope_theta=10_000.0,
        num_experts=128, top_k=2, capacity_factor=1.25,
        moe_dense_residual=True, dense_ff=4864, first_k_dense=0,
        # gather dispatch (§Perf H14): -15% compute / -27% memory / -39%
        # collective vs GShard einsum AND brings train_4k under 16GB/chip.
        # (einsum stays the default family-wide: on moonshot-64e-top6 the
        # same change inflates collectives 4.3x.)
        moe_impl="gather",
        # fp32 AdamW for 480B does not fit 256 x 16GB; bf16 params +
        # Adafactor states (see RunConfig override in launch/dryrun.py).
        param_dtype=torch.bfloat16,
        head_pad_multiple=16,
        grad_accum_dtype=torch.bfloat16,

    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=32,
        attention="gqa", mlp_act="swiglu",
        num_experts=8, top_k=2, capacity_factor=2.0,
        moe_dense_residual=True, dense_ff=128, first_k_dense=0,
    )
