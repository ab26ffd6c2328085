"""The port's Q axis (`repro_torch.quant`) against the reference's, on the
CPU.

Inputs come from numpy with a seed and go to both sides. Tolerances:
quantization, the int8 `linear` and `quantize_tree` are bit for bit (the
same round-half-even, clip and fp32 arithmetic, and an int32 sum that does
not depend on its order); the fp8 `linear` within one bf16 step of the
result, 2**-7 relative (both dequantize to the same bf16 weights and
accumulate in fp32, in another order, before rounding once to bf16).
"""
import re

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
from repro_torch.quant import (BY_NAME, INV_127, SKIP, QuantConfig,
                               act_scale, linear, quantize_tree,
                               quantize_weight, stored)
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


def _served_inputs(amax):
    """bf16 x (8, 4096) whose largest magnitude is exactly `amax`, and a
    bf16 weight (4096, 1024) quantized by the reference, eagerly."""
    rng = np.random.default_rng(4)
    x = np.clip(rng.normal(size=(8, 4096)), -1, 1)
    x[3, 17] = -amax
    xj = jnp.asarray(x, jnp.bfloat16)
    wq = jquantize_weight(jnp.asarray(rng.normal(size=(4096, 1024)) * 0.02,
                                      jnp.bfloat16), "int8")
    return xj, wq


def _served_linear():
    return jax.jit(jlinear, static_argnums=2)


@pytest.mark.parametrize("amax", [1.125, 1.625, 3.25])
def test_int8_linear_bit_exact_against_the_served_jit(amax):
    """The served step functions run `repro.quant.linear` under `jax.jit`
    (`repro.serving.runner`), where the activation scale is amax *
    fl32(1/127). At these amax that is one float32 step from amax / 127,
    so a quotient would move outputs; the port's `linear` gives the jitted
    reference's outputs bit for bit, on weights the reference quantized."""
    xj, wq = _served_inputs(amax)
    xt = to_torch(np.asarray(xj))
    w = {"q": stored(to_torch(np.asarray(wq["q"]))),
         "scale": to_torch(np.asarray(wq["scale"]))}
    _same(linear(xt, w, BY_NAME["int8"]),
          _served_linear()(xj, wq, JBY_NAME["int8"]))


@pytest.mark.parametrize("K,N", [(1365, 1024), (1024, 1365)])
def test_int8_linear_at_ragged_shapes_against_the_served_jit(K, N):
    """xlstm-350m's sLSTM projections, down (K 1365) and up (N 1365): on
    weights the reference quantized, stored K-major in rows padded to 1376
    bytes, and activations whose rows the port pads the same way before the
    kernel's plain version, `linear` (8 x 512 rows, a prefill, and 8 rows,
    a decode step) gives the jitted reference's outputs bit for bit."""
    rng = np.random.default_rng(9)
    wq = jquantize_weight(jnp.asarray(rng.normal(size=(K, N)) * 0.02,
                                      jnp.bfloat16), "int8")
    w = {"q": stored(to_torch(np.asarray(wq["q"]))),
         "scale": to_torch(np.asarray(wq["scale"]))}
    assert w["q"].stride() == (1, -(-K // 16) * 16)
    for shape in ((8, 512, K), (8, 1, K)):
        xj, xt = _pair(rng, shape, "bfloat16")
        out = linear(xt, w, BY_NAME["int8"])
        assert out.shape == shape[:-1] + (N,)
        _same(out, _served_linear()(xj, wq, JBY_NAME["int8"]))


def test_act_scale_constant_is_the_jitted_references():
    """`INV_127` is the constant by which XLA's compiled reference
    multiplies the activations' amax (the op it lowers `xamax / 127.0`
    to), and `act_scale` is that product."""
    xj, wq = _served_inputs(1.125)
    hlo = _served_linear().lower(xj, wq, JBY_NAME["int8"]).compile().as_text()
    consts = dict(re.findall(r"%(constant[.\d]*) = f32\[\] constant\(([^)]+)\)",
                             hlo))
    divs = re.findall(r"= f32\[\] multiply\(%[\w.]+, %(constant[.\d]*)\).*"
                      r'op_name="jit\(linear\)/div"', hlo)
    assert divs, "the jitted reference no longer forms xamax / 127.0 as a product"
    for name in divs:
        assert np.float32(consts[name]) == np.float32(INV_127)
    xt = to_torch(np.asarray(xj)).float()
    assert act_scale(xt).item() == np.float32(1.125) * np.float32(INV_127)


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
