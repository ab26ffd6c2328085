from repro_torch.kernels.moe_gemm.ops import moe_gemm  # noqa: F401
