"""Config for --arch llama4-maverick-400b-a17b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [hf:meta-llama/Llama-4] MoE 128e top-1, interleaved dense/MoE.
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, expert_ff=8192, interleave=2,
                  shared_expert_ff=8192),
    frontend="vision_patches", frontend_len=0,  # early fusion (stub off by default)
)
