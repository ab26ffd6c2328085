"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  paged_attention/  decode over the paged KV pool  (csrc/paged_attention.cu)
  flash_attention/  causal prefill attention       (csrc/flash_attention.cu)
  int8_matmul/      int8 GEMM, fused dequantization (csrc/int8_matmul.cu)

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
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (BF16_ATOL + BF16_RTOL * ref.abs()))
                 .max())
