"""Config for --arch granite-moe-1b-a400m."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [hf:ibm-granite/granite-3.0-1b-a400m-base] 32 experts top-8.
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, expert_ff=512),
    tie_embeddings=True,
)
