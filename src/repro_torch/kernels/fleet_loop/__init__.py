from repro_torch.kernels.fleet_loop.ops import fleet_loop  # noqa: F401
