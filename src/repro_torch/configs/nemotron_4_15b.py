"""Config for --arch nemotron-4-15b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2402.16819] GQA, squared-ReLU MLP.
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    mlp_kind="relu2", norm_kind="layernorm",
)
