"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  paged_attention/  decode over the paged KV pool  (csrc/paged_attention.cu)
  flash_attention/  causal prefill attention       (csrc/flash_attention.cu)
  int8_matmul/      int8 GEMM, fused dequantization (csrc/int8_matmul.cu)
  ssm_scan/         Mamba selective scan, fp32     (csrc/ssm_scan.cu)

Each subpackage has `ref.py` (plain version), `kernel.py` (ctypes binding
with a launch count) and `ops.py` (dispatch: kernel for CUDA tensors,
plain version for CPU tensors). `build.py` compiles `csrc/*.cu`.
"""
import torch

# The gate that holds a bf16 kernel against its plain version. Both compute
# in fp32 and round the result once to bf16, so they may differ by one bf16
# step of the result, which is at most 2**-7 of its magnitude; BF16_ATOL
# covers fp32 summation-order noise in results near 0. An absolute gate
# would be no tighter than the outputs' own size (about 0.06 for attention
# over ~700 random positions), and would pass a kernel that drops a page.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-3


def bf16_gate(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (BF16_ATOL + BF16_RTOL |ref|): at most 1 when a
    bf16 kernel agrees with its plain version."""
    return _gate(out, ref, BF16_ATOL, BF16_RTOL)


# The gate that holds an fp32 kernel (the selective scan) against its plain
# version. Both run the same fp32 recurrence, op for op, but not bit for
# bit: nvcc contracts a*h + b into one FMA (one rounding fewer), and the
# plain version sums y's N products in the order of its einsum. Each step
# adds a few ulps (2**-23 = 1.2e-7 relative) of the step's terms, and the
# carried state decays (exp(dt*A) < 1), so the difference stays at tens of
# ulps: FP32_RTOL is ~800 ulps. FP32_ATOL covers results near 0, where y's
# N terms cancel and leave an absolute difference of a few ulps of the
# terms themselves (|h C| up to ~10 on unit-normal inputs).
FP32_RTOL = 1e-4
FP32_ATOL = 1e-5


def fp32_gate(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (FP32_ATOL + FP32_RTOL |ref|): at most 1 when an
    fp32 kernel agrees with its plain version."""
    return _gate(out, ref, FP32_ATOL, FP32_RTOL)


def _gate(out, ref, atol, rtol) -> float:
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())
