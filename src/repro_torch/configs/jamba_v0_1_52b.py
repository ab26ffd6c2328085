"""Config for --arch jamba-v0.1-52b."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2403.19887] Mamba+attn 1:7 interleave, MoE 16e top-2.
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=14336, interleave=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8, rope_kind="none",  # jamba uses no positional encoding
)
