"""Model zoo: the decoders that the live server runs: attention, dense or
MoE, and the hybrid of attention and Mamba layers."""
from repro_torch.models.model import init_params  # noqa: F401
