from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: F401
