"""Config for --arch mixtral-8x7b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2401.04088] the paper's sparse MoE (C5/C6): 12.9B active / 46.7B.
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=14336),
)
