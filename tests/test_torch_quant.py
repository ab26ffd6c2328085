"""The port's Q axis (`repro_torch.quant`) against the reference's, on the
CPU.

Inputs come from numpy with a seed and go to both sides. Tolerances:
quantization, the int8 `linear` and `quantize_tree` are bit for bit (the
same round-half-even, clip and fp32 arithmetic, and an int32 sum that does
not depend on its order); the fp8 `linear` within one bf16 step of the
result, 2**-7 relative (both dequantize to the same bf16 weights and
accumulate in fp32, in another order, before rounding once to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.quant import BY_NAME as JBY_NAME
from repro.quant import QuantConfig as JQuantConfig
from repro.quant import linear as jlinear
from repro.quant import quantize_tree as jquantize_tree
from repro.quant import quantize_weight as jquantize_weight
from repro_torch.configs import reduced
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.quant import (BY_NAME, SKIP, QuantConfig, linear,
                               quantize_tree, quantize_weight)
from repro_torch.weights import params_from_jax, to_torch


def _pair(rng, shape, dtype, scale=1.0):
    a = jnp.asarray(rng.normal(size=shape) * scale, dtype)
    return a, to_torch(np.asarray(a))


def _equal(a: torch.Tensor, b: torch.Tensor):
    """Bit-for-bit equality, dtype and shape included."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype in (torch.float8_e4m3fn, torch.bfloat16):
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    assert torch.equal(a, b)


def _same(port: torch.Tensor, ref):
    """The port's tensor is the reference's array, bit for bit."""
    _equal(port, to_torch(np.asarray(ref)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 128, 48)])
def test_quantize_weight_bit_exact(mode, shape):
    rng = np.random.default_rng(0)
    wj, wt = _pair(rng, shape, "bfloat16", scale=0.02)
    wt = wt.clone()
    wt[..., 0, :] *= 40                  # outliers set some channels' scale
    wj = jnp.asarray(np.asarray(wt.float()), jnp.bfloat16)
    ref, port = jquantize_weight(wj, mode), quantize_weight(wt, mode)
    _same(port["q"], ref["q"])
    _same(port["scale"], ref["scale"])
    assert port["scale"].shape == shape[:-2] + (1, shape[-1])


def test_quantize_weight_bf16_passes_through():
    w = torch.ones(4, 4, dtype=torch.bfloat16)
    out = quantize_weight(w, "bf16")
    assert out["q"] is w and out["scale"] is None


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ["llama31-8b", "qwen3-30b-a3b"])
def test_quantize_tree_matches_reference(mode, arch):
    """The port's quantize_tree on the converted bf16 tree gives, leaf for
    leaf, the converted tree of the reference's quantize_tree; the SKIP
    leaves (embed, norm scales, the fp32 router) stay as they were."""
    cfg = reduced(arch, vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(1), jax_reduced(arch, vocab=1024))
    port = quantize_tree(params_from_jax(jax.tree.map(np.asarray, jp), cfg),
                         mode)
    ref = params_from_jax(jax.tree.map(np.asarray, jquantize_tree(jp, mode)),
                          cfg)
    flat_p = jax.tree_util.tree_flatten_with_path(port)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
    n_quantized = 0
    for (path, a), (_, b) in zip(flat_p, flat_r):
        _equal(a, b)
        n_quantized += path[-1].key == "q"
    layer = port["layers"][0]
    assert layer["ln1"]["scale"].dtype == torch.bfloat16
    assert port["embed"].dtype == torch.bfloat16
    assert port["lm_head"]["q"].dtype in (torch.int8, torch.float8_e4m3fn)
    if "moe" in layer:
        assert layer["moe"]["router"].dtype == torch.float32
        assert set(layer["moe"]["experts_up"]) == {"q", "scale"}
    # lm_head, and per layer wq, wk, wv, wo and three MLP or expert weights
    assert n_quantized == 1 + 7 * cfg.num_layers


def test_quantize_tree_skips_what_linear_does_not_read():
    """Every SKIP name, fp32 matrices and 1D vectors stay as they are."""
    tree = {name: torch.ones(4, 4, dtype=torch.bfloat16) for name in SKIP}
    tree["f32"] = torch.ones(4, 4)
    tree["vec"] = torch.ones(4, dtype=torch.bfloat16)
    tree["w"] = [torch.ones(4, 4, dtype=torch.bfloat16)]
    out = quantize_tree(tree, "int8")
    for name in list(SKIP) + ["f32", "vec"]:
        assert out[name] is tree[name]
    assert set(out["w"][0]) == {"q", "scale"}
    assert quantize_tree(tree, "bf16") is tree


@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
def test_int8_linear_bit_exact(xdtype):
    """Per-tensor activation quantization, the int32 product and the
    dequantization give the reference's output bit for bit, through the
    kernel's plain version (the kernel never launches on the CPU)."""
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (4, 16, 256), xdtype)
    wj, wt = _pair(rng, (256, 384), "bfloat16", scale=0.02)
    n = int8_matmul_kernel.launches
    out = linear(xt, quantize_weight(wt, "int8"), BY_NAME["int8"])
    assert int8_matmul_kernel.launches == n
    assert out.dtype == xt.dtype and out.shape == (4, 16, 384)
    _same(out, jlinear(xj, jquantize_weight(wj, "int8"), JBY_NAME["int8"]))


@pytest.mark.parametrize("mode,native", [("fp8", False), ("fp8", True),
                                         ("int8", False)])
def test_dequantizing_linear_within_one_bf16_step(mode, native):
    """fp8 (emulated and `fp8_native`) and non-native int8 dequantize the
    weight to bf16 and run a bf16 matmul, as the reference does."""
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (4, 16, 256), "bfloat16")
    wj, wt = _pair(rng, (256, 384), "bfloat16", scale=0.02)
    qcfg = QuantConfig(mode, native=native)
    qname = mode if mode == "int8" else "fp8"
    out = linear(xt, quantize_weight(wt, qname), qcfg)
    ref = jlinear(xj, jquantize_weight(wj, qname),
                  JQuantConfig(mode, native=native))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_by_name_matches_reference():
    assert set(BY_NAME) == set(JBY_NAME)
    for name, q in BY_NAME.items():
        r = JBY_NAME[name]
        assert (q.mode, q.native, q.act_quant, q.weight_bytes) == \
            (r.mode, r.native, r.act_quant, r.weight_bytes)
    with pytest.raises(ValueError):
        QuantConfig("int4")
