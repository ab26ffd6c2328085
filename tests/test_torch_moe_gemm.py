"""The int8 experts' grouped GEMM (`repro_torch.kernels.moe_gemm`) on the
CPU: its plain version, and the rule that sends an expert stack to it.

The plain version is what the MoE computed before the kernel: the einsum
on `quant.dequantize`'s bf16 weights. It must equal the model's own
einsum (`egcd,edf->egcf`, on the (E, G, C, K) dispatch tensor) bit for
bit, at the served MoE configurations' expert shapes with d and f cut by
16, at 1, 3 and 80 rows an expert. The kernel itself runs on the card
only (`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`'s
`check_moe_gemm`).
"""
import pytest
import torch

from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.models import moe as tmoe
from repro_torch.quant import dequantize, quantize_weight

# (E, d, f) of mixtral-8x7b, jamba-v0.1-52b, llama4-maverick-400b-a17b,
# qwen3-30b-a3b and granite-moe-1b-a400m, d and f cut by 16
SHAPES = {"mixtral-8x7b": (8, 256, 896), "jamba-v0.1-52b": (16, 256, 896),
          "llama4-maverick-400b-a17b": (128, 320, 512),
          "qwen3-30b-a3b": (128, 128, 48),
          "granite-moe-1b-a400m": (32, 64, 32)}


@pytest.mark.parametrize("rows,G", [(1, 1), (3, 1), (80, 4)])
@pytest.mark.parametrize("which", ["up", "down"])
@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_plain_version_is_the_models_einsum_bit_for_bit(arch, which, rows,
                                                        G):
    E, d, f = SHAPES[arch]
    K, N = (d, f) if which == "up" else (f, d)
    gen = torch.Generator().manual_seed(
        100 * sorted(SHAPES).index(arch) + 2 * rows + (which == "up"))
    w = (torch.randn(E, K, N, generator=gen) * 0.02).bfloat16()
    wq = quantize_weight(w, "int8")
    x = torch.randn(E, G, rows // G, K, generator=gen).bfloat16()
    got = moe_gemm(x.reshape(E, rows, K), wq["q"], wq["scale"])
    want = torch.einsum("egcd,edf->egcf", x,
                        dequantize(wq["q"], wq["scale"]))
    assert got.dtype == torch.bfloat16 and got.shape == (E, rows, N)
    assert torch.equal(got, want.reshape(E, rows, N))
    assert torch.equal(got, moe_gemm_ref(x.reshape(E, rows, K), wq["q"],
                                         wq["scale"]))


@pytest.mark.parametrize("dtype,device,sharded,takes", [
    (torch.int8, "cuda", False, True),
    (torch.int8, "cpu", False, False),
    (torch.int8, "cuda", True, False),
    (torch.float8_e4m3fn, "cuda", False, False),
    (torch.bfloat16, "cuda", False, False),
])
def test_dispatch_rule(dtype, device, sharded, takes):
    """int8 codes on a CUDA device, not a DTensor, take the grouped GEMM;
    bf16, fp8, sharded and CPU experts take `_w` and the einsum."""
    assert tmoe.gemm_takes(dtype, device, sharded) is takes


@pytest.mark.parametrize("mode", ["bf16", "int8", "fp8"])
def test_cpu_experts_take_the_einsum(mode):
    w = (torch.randn(4, 16, 32) * 0.02).bfloat16()
    x = torch.zeros(4, 1, 2, 16, dtype=torch.bfloat16)
    wp = quantize_weight(w, mode) if mode != "bf16" else w
    assert not tmoe.uses_gemm(wp, x)
    if mode == "bf16":
        assert not tmoe.uses_gemm(quantize_weight(w, "bf16"), x)
