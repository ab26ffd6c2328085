"""The port's model building blocks against the reference's, on the CPU.

Inputs come from numpy with a seed and go to both sides. Tolerances:
f32 1e-5 (the same fp32 arithmetic, summed in another order); bf16 one
bf16 rounding step of the result, 2**-7 relative (both sides compute in
fp32 and round once, so they may land on neighbouring bf16 values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.quant import linear as jlinear
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as tattn
from repro_torch.models import init_params
from repro_torch.models import layers as tlayers
from repro_torch.quant import linear as tlinear
from repro_torch.weights import params_from_jax, to_torch

DTYPES = ["float32", "bfloat16"]


def _pair(rng, shape, dtype, scale=1.0):
    a = jnp.asarray(rng.normal(size=shape) * scale, dtype)
    return a, to_torch(np.asarray(a))


def _close(port, ref, dtype):
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(port, ref, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(dtype, kind):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (3, 5, 64), dtype)
    sj, st = _pair(rng, (64,), dtype)
    bj, bt = _pair(rng, (64,), dtype)
    pj, pt = {"scale": sj, "bias": bj}, {"scale": st, "bias": bt}
    out = tlayers.apply_norm(pt, xt, kind)
    assert out.dtype == xt.dtype
    _close(out, jlayers.apply_norm(pj, xj, kind), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 7, 4, 32), dtype)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    out = tattn.apply_rope(xt, torch.from_numpy(pos), 500000.0)
    _close(out, jattn.apply_rope(xj, jnp.asarray(pos), 500000.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp(dtype, kind):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (2, 3, 64), dtype)
    names = ("gate", "up", "down") if kind == "swiglu" else ("up", "down")
    pj, pt = {}, {}
    for n in names:
        shape = (128, 64) if n == "down" else (64, 128)
        pj[n], pt[n] = _pair(rng, shape, dtype, scale=0.1)
    out = tlayers.apply_mlp(pt, xt, kind)
    # bf16: the hidden activation is rounded to bf16 by both before the
    # down projection, so one rounding step there can move the result by
    # a few bf16 steps; f32 as above.
    ref = jlayers.apply_mlp(pj, xj, kind)
    if dtype == "float32":
        _close(out, ref, dtype)
    else:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_linear(dtype):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (4, 3, 64), dtype)
    wj, wt = _pair(rng, (64, 96), dtype)
    out = tlinear(xt, wt)
    assert out.dtype == xt.dtype and out.shape == (4, 3, 96)
    _close(out, jlinear(xj, wj), dtype)


def test_linear_quantized_not_ported():
    """A native fp8 GEMM is not ported, because the reference has none:
    `fp8_native` dequantizes to bf16 exactly as the emulated `fp8` does,
    bit for bit, and matches the reference within one bf16 step."""
    from repro.quant import BY_NAME as JBY_NAME
    from repro.quant import quantize_weight as jquantize_weight
    from repro_torch.quant import BY_NAME, quantize_weight
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng, (4, 3, 64), "bfloat16")
    wj, wt = _pair(rng, (64, 96), "bfloat16", scale=0.02)
    native = tlinear(xt, quantize_weight(wt, "fp8"), BY_NAME["fp8_native"])
    emulated = tlinear(xt, quantize_weight(wt, "fp8"), BY_NAME["fp8"])
    assert torch.equal(native, emulated)
    _close(native, jlinear(xj, jquantize_weight(wj, "fp8"),
                           JBY_NAME["fp8_native"]), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_bit_exact(dtype):
    cfg = jax_reduced("llama31-8b", vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.dtype(dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), reduced(
        "llama31-8b", vocab=1024))
    assert len(tp["layers"]) == cfg.num_layers
    for r in range(cfg.num_layers):
        blk = jp["blocks"][0]
        for path in (("ln1", "scale"), ("attn", "wq"), ("attn", "wk"),
                     ("attn", "wv"), ("attn", "wo"), ("ln2", "scale"),
                     ("mlp", "gate"), ("mlp", "up"), ("mlp", "down")):
            a = np.asarray(blk[path[0]][path[1]][r])
            t = tp["layers"][r][path[0]][path[1]]
            assert str(t.dtype) == f"torch.{dtype}"
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32))
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(tp[name].float().numpy(),
                                      np.asarray(jp[name], np.float32))


def test_init_params_shapes_and_scale():
    cfg = reduced("llama31-8b", vocab=1024)
    p = init_params(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert p["embed"].shape == (1024, 64) and p["embed"].dtype == torch.bfloat16
    assert len(p["layers"]) == cfg.num_layers
    assert p["layers"][0]["attn"]["wk"].shape == (64, 16 * cfg.num_kv_heads)
    assert abs(float(p["lm_head"].float().std()) - 0.02) < 2e-3
    full = get_config("llama31-8b")
    assert (full.d_model, full.num_heads, full.num_kv_heads, full.d_ff,
            full.vocab_size) == (4096, 32, 8, 14336, 128256)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ["llama31-8b", "qwen3-30b-a3b"])
def test_params_from_jax_quantized_and_moe_bit_exact(mode, arch):
    """Quantized leaves ({"q", "scale"} stacked over R; fp8 through a uint8
    view) and MoE blocks (experts (R, E, d, f), router (R, d, E) fp32)
    arrive bit for bit, cut per layer."""
    from repro.quant import quantize_tree as jquantize_tree
    cfg = jax_reduced(arch, vocab=1024)
    jp = jquantize_tree(jax_init_params(jax.random.PRNGKey(0), cfg), mode)
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         reduced(arch, vocab=1024))
    qdtype = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    ff = ("moe", "experts_up") if cfg.moe else ("mlp", "up")
    for r in range(cfg.num_layers):
        blk = jp["blocks"][0]
        for path in (("attn", "wq"), ("attn", "wo"), ff):
            leaf = blk[path[0]][path[1]]
            got = tp["layers"][r][path[0]][path[1]]
            assert got["q"].dtype == qdtype
            np.testing.assert_array_equal(
                got["q"].view(torch.uint8 if mode == "fp8" else torch.int8)
                .numpy(),
                np.asarray(leaf["q"][r]).view(np.uint8 if mode == "fp8"
                                              else np.int8))
            np.testing.assert_array_equal(got["scale"].numpy(),
                                          np.asarray(leaf["scale"][r]))
        if cfg.moe:
            router = tp["layers"][r]["moe"]["router"]
            assert router.dtype == torch.float32
            assert router.shape == (cfg.d_model, cfg.moe.num_experts)
            np.testing.assert_array_equal(
                router.numpy(), np.asarray(blk["moe"]["router"][r]))
            assert got["q"].shape == (cfg.moe.num_experts, cfg.d_model,
                                      cfg.moe.expert_ff)
    assert tp["lm_head"]["q"].dtype == qdtype


@pytest.mark.parametrize("quant", ["bf16", "int8", "fp8"])
def test_init_params_moe_quantized(quant):
    """qwen3's MoE blocks drawn and quantized layer by layer, the lm_head
    too; the embedding and the router are not quantized."""
    cfg = reduced("qwen3-30b-a3b", vocab=1024)
    p = init_params(cfg, device="cpu", quant=quant,
                    generator=torch.Generator().manual_seed(0))
    moe = p["layers"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert p["embed"].dtype == torch.bfloat16
    if quant == "bf16":
        assert moe["experts_up"].shape == (4, 64, 128)
        assert p["lm_head"].dtype == torch.bfloat16
    else:
        assert set(moe["experts_up"]) == {"q", "scale"}
        assert moe["experts_up"]["scale"].shape == (4, 1, 128)
        assert set(p["lm_head"]) == {"q", "scale"}
        assert set(p["layers"][0]["attn"]["wq"]) == {"q", "scale"}
    full = get_config("qwen3-30b-a3b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.moe.num_experts, full.moe.top_k, full.moe.expert_ff,
            full.vocab_size) == (48, 2048, 32, 4, 128, 8, 768, 151936)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_params_from_jax_hybrid_bit_exact(mode):
    """jamba's layers arrive by kind, bit for bit: layer r*U + j is repeat
    r of unit position j; a Mamba layer's projections (quantized under
    int8), its conv_w and its fp32 A_log, D and dt_bias (never quantized),
    the attention layer's projections, and the reference's stacked serving
    state cut per layer by `pools_from_jax`."""
    from repro.quant import quantize_tree as jquantize_tree
    from repro.serving.runner import init_pools as jinit_pools
    from repro_torch.weights import pools_from_jax
    cfg = jax_reduced("jamba-v0.1-52b", vocab=1024)
    tcfg = reduced("jamba-v0.1-52b", vocab=1024)
    jp = jquantize_tree(jax_init_params(jax.random.PRNGKey(0), cfg), mode)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    U = len(jp["blocks"])
    for i, (kind, is_moe) in enumerate(zip(tcfg.block_pattern(),
                                           tcfg.moe_layer_mask())):
        blk, r, layer = jp["blocks"][i % U], i // U, tp["layers"][i]
        assert (kind in layer) and ("moe" in layer) == is_moe
        names = (("in_proj", "x_proj", "dt_proj", "out_proj") if kind ==
                 "mamba" else ("wq", "wk", "wv", "wo"))
        for n in names:
            a, t = blk[kind][n], layer[kind][n]
            if mode == "int8":
                a, t = a["q"], t["q"]
            np.testing.assert_array_equal(
                t.view(torch.int16 if mode == "bf16" else torch.int8)
                .numpy(), np.asarray(a[r]).view(
                    np.int16 if mode == "bf16" else np.int8))
        if kind == "mamba":
            for n in ("conv_w", "A_log", "D", "dt_bias"):
                t = layer["mamba"][n]
                assert not isinstance(t, dict), n
                np.testing.assert_array_equal(
                    t.float().numpy(),
                    np.asarray(blk["mamba"][n][r], np.float32))
            assert layer["mamba"]["A_log"].dtype == torch.float32
    pools = pools_from_jax(jax.tree.map(np.asarray, jinit_pools(
        cfg, 8, 4, 3)), tcfg)
    assert [set(p) for p in pools] == [
        {"k", "v"} if k == "attn" else {"conv", "h"}
        for k in tcfg.block_pattern()]
    assert pools[0]["h"].shape == (3, 128, 4)
    assert pools[0]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("quant", ["bf16", "int8", "fp8"])
def test_init_params_hybrid(quant):
    """jamba drawn layer by layer by kind: Mamba layers with ln1 + mamba,
    the attention layer with ln1 + attn, each with ln2 + a dense MLP or
    (every second layer) MoE; the Mamba tensors that `linear` never
    reads stay as they are. The full config is the reference's."""
    cfg = reduced("jamba-v0.1-52b", vocab=1024)
    p = init_params(cfg, device="cpu", quant=quant,
                    generator=torch.Generator().manual_seed(0))
    kinds = [("attn" if "attn" in lay else "mamba",
              "moe" if "moe" in lay else "mlp") for lay in p["layers"]]
    assert kinds == [(k, "moe" if m else "mlp") for k, m in
                     zip(cfg.block_pattern(), cfg.moe_layer_mask())]
    m = p["layers"][0]["mamba"]
    assert m["A_log"].dtype == torch.float32 and m["A_log"].shape == (128, 4)
    assert m["conv_w"].dtype == torch.bfloat16
    assert isinstance(m["in_proj"], dict) == (quant != "bf16")
    full = get_config("jamba-v0.1-52b")
    assert full.block_pattern().count("attn") == 4
    assert sum(full.moe_layer_mask()) == 16
    assert abs(full.param_count() / 1e9 - 51.57) < 0.01
