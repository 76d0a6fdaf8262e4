"""Model / run configuration dataclasses (mirror of ``repro.configs.base``).

Field names, defaults and derived properties are those of the JAX
package, so a config built here compares field for field with its JAX
counterpart; dtype fields hold torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

# kernel dispatch modes (kernels/ops.py): "auto" = the hand-written CUDA
# kernel for CUDA tensors and the plain PyTorch version for CPU tensors;
# "cuda" forces the kernel (raises on CPU tensors); "ref" pins the plain
# version on every device
DECODE_IMPLS = ("auto", "cuda", "ref")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // num_heads

    # temporal mixer
    attention: str = "gqa"  # gqa | mla | local | rglru-hybrid | xlstm | encdec
    rope_theta: float = 10_000.0
    window: int = 0  # local attention window (0 = full)
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w)

    # MLA (minicpm3 / deepseek style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    dense_ff: int = 0                 # arctic dense-residual FFN width
    first_k_dense: int = 1            # leading dense layers in MoE stacks
    moe_impl: str = "einsum"          # einsum | gather

    # hybrid / recurrent
    rglru_pattern: int = 0   # griffin: every Nth layer is local-attn (1:N-1)
    rnn_width: int = 0       # rg-lru width (0 -> d_model)
    conv_width: int = 4
    slstm_every: int = 0     # xlstm: every Nth block is sLSTM

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_decoder_layers: int = 0
    dec_len_ratio: int = 8  # dec_len = enc_len // ratio for train/prefill

    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    input_kind: str = "tokens"  # tokens | embeds

    # pad num_heads up to a multiple with zero-init pad heads (exact at
    # inference) so the head count divides a tensor-parallel axis; 0 = off
    head_pad_multiple: int = 0
    seq_parallel: bool = False
    remat_policy: str = "full"
    grad_accum_dtype: Any = torch.float32
    fsdp_over_pod: bool = False

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # attention chunk sizes of the no-cache reference path
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # paged-attention dispatch for the serving hot path: one of DECODE_IMPLS
    decode_impl: str = "auto"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def qk_head_dim(self) -> int:
        if self.attention == "mla":
            return self.nope_head_dim + self.rope_head_dim
        return self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 16 (pad rows are benign extra
        tokens), as the JAX package pads it."""
        return -(-self.vocab_size // 16) * 16

    def padded_gqa(self):
        """(H_pad, KV_pad): the smallest padded head count that is a
        multiple of ``head_pad_multiple`` with a uniform group size; zero
        pad heads keep the padded network exact."""
        m = self.head_pad_multiple
        H, KV = self.num_heads, self.num_kv_heads
        if not m or H % m == 0:
            return H, KV
        G = H // KV
        best = None
        for kvp in range(KV, KV + m + 1):
            for gp in range(G, G + m + 1):
                hp = kvp * gp
                if hp % m == 0 and (best is None or hp < best[0]):
                    best = (hp, kvp)
        return best

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# smoke-scale variants of the same shape kinds (CPU-runnable)
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeConfig("long_500k", 256, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Per-(arch x shape) runtime knobs (microbatching, optimizer, remat)."""

    num_microbatches: int = 1
    optimizer: str = "adamw"       # adamw | adafactor
    opt_state_dtype: Any = torch.float32
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    remat: str = "layer"           # none | layer
    grad_compression: str = "none"  # none | int8


def block_pattern(cfg: ModelConfig):
    """(head, unit, repeats, tail): per-layer (temporal, channel) block kinds.

    ``head`` layers run first, then ``unit`` repeats ``repeats`` times
    (its parameters stacked on a leading ``[repeats]`` dim), then ``tail``.
    """
    L = cfg.num_layers
    if cfg.attention == "xlstm":
        k = cfg.slstm_every or 4
        unit = tuple(
            ("slstm", None) if (i % k == k - 1) else ("mlstm", None) for i in range(k)
        )
        reps, tail_n = divmod(L, k)
        return (), unit, reps, unit[:tail_n]
    if cfg.attention == "rglru-hybrid":
        k = cfg.rglru_pattern or 3  # griffin: (rglru, rglru, local-attn)
        unit = tuple(
            ("local", "mlp") if (i % k == k - 1) else ("rglru", "mlp")
            for i in range(k)
        )
        reps, tail_n = divmod(L, k)
        return (), unit, reps, unit[:tail_n]
    temporal = "mla" if cfg.attention == "mla" else (
        "local" if cfg.attention == "local" else "attn")
    if cfg.num_experts > 0:
        fkd = cfg.first_k_dense
        head = tuple((temporal, "mlp") for _ in range(fkd))
        return head, ((temporal, "moe"),), L - fkd, ()
    return (), ((temporal, "mlp"),), L, ()
