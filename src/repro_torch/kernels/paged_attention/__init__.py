from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: F401
