"""Model zoo: the attention decoders, dense and MoE, that the live server
runs."""
from repro_torch.models.model import init_params  # noqa: F401
