"""Model zoo: the dense decoder subset that the live server runs."""
from repro_torch.models.model import init_params  # noqa: F401
