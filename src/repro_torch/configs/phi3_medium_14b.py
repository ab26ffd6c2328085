"""Config for --arch phi3-medium-14b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2404.14219] RoPE SwiGLU GQA.
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352,
)
