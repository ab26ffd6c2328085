"""Config for --arch qwen3-30b-a3b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2505.09388] the paper's ultra-sparse MoE (C3/C4): 3B active / 30B.
    name="qwen3-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=6144, vocab_size=151936, head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768),
)
