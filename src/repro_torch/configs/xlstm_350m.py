"""Config for --arch xlstm-350m."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig)

CONFIG = ModelConfig(
    # [arXiv:2405.04517] sLSTM + mLSTM blocks; d_ff=0 (ff inside blocks).
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=2), rope_kind="none",
    tie_embeddings=True,
)
