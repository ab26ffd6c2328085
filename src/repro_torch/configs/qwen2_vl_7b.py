"""Config for --arch qwen2-vl-7b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2409.12191] M-RoPE, dynamic resolution (stubbed patches).
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    rope_kind="mrope", frontend="vision_patches", frontend_len=1024,
)
