from repro_torch.kernels.adamw8bit.ops import adamw8bit_update  # noqa: F401
