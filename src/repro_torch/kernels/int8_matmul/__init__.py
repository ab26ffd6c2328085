from repro_torch.kernels.int8_matmul.ops import int8_matmul  # noqa: F401
