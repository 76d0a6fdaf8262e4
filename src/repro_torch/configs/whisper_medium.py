"""whisper-medium [audio] — enc-dec; conv frontend is a STUB
(input_specs supplies frame embeddings) [arXiv:2212.04356].

dec_len = enc_len // dec_len_ratio for train/prefill shapes."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865, head_dim=64,
        attention="encdec", mlp_act="gelu", input_kind="embeds",
        is_encoder_decoder=True, num_decoder_layers=24, dec_len_ratio=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="encdec", mlp_act="gelu", input_kind="embeds",
        is_encoder_decoder=True, num_decoder_layers=2, dec_len_ratio=8,
    )
