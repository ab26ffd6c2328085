"""Config for --arch granite-34b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2405.04324] llama-arch code model, MQA (kv=1), 88 layers.
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    mlp_kind="gelu",  # GPT-BigCode-style non-gated MLP -> ~34B total params
)
