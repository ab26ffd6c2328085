"""Config for --arch whisper-base."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2212.04356] enc-dec, conv frontend stubbed (frame embeddings).
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    mlp_kind="gelu", norm_kind="layernorm", rope_kind="none",
    encoder_layers=6, frontend="audio_frames", frontend_len=1500,
    tie_embeddings=True,
)
