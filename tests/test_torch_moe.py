"""The port's MoE block (`repro_torch.models.moe`) against the reference's
`repro.models.moe.apply_moe`, on the CPU.

Parameters are drawn by the reference and converted; inputs come from
numpy with a seed. The outputs have an RMS of about 0.002 (weights
normal x 0.02). Tolerances: f32 1e-5 relative and 1e-7 absolute (the same
fp32 arithmetic summed in another order: measured 2e-9); bf16 2**-7
relative and 1.5e-4 absolute, about two bf16 steps at the outputs' size
(both round the expert activations to bf16 at the same places, so one
rounding step of a hidden unit, carried through the down projection, can
move an output by a step: measured 6.1e-5, one step at 0.01); the aux
loss 1e-5 relative in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.quant import quantize_tree as jquantize_tree
from repro_torch.configs import MoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.weights import to_torch

D = 64
CFG = dict(num_experts=4, top_k=2, expert_ff=128, group_size=16)
TOL = {"float32": (1e-5, 1e-7), "bfloat16": (2 ** -7, 1.5e-4)}


def _params(dtype, key=0, **cfg):
    jcfg = JMoEConfig(**{**CFG, **cfg})
    jp = jmoe.init_moe(jax.random.PRNGKey(key), D, jcfg, "swiglu",
                       jnp.dtype(dtype))
    return jcfg, jp


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return to_torch(np.asarray(tree))


def _run(jcfg, jp, x_np, dtype):
    """(port out, port aux, ref out, ref aux) on the same input."""
    xj = jnp.asarray(x_np, dtype)
    ref, aux_r = jmoe.apply_moe(jp, xj, jcfg, "swiglu")
    tcfg = MoEConfig(**dataclasses.asdict(jcfg))
    out, aux = tmoe.apply_moe(_to_torch(jp), to_torch(np.asarray(xj)), tcfg,
                              "swiglu")
    assert out.dtype == to_torch(np.asarray(xj)).dtype
    return out, aux, ref, aux_r


def _close(out, aux, ref, aux_r, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(4, 64), (8, 1), (2, 8)])
def test_apply_moe_matches_reference(dtype, B, S):
    """Prefill-like (4 x 64 tokens, groups of 16), decode-like (8 x 1,
    one group of 8) and a group smaller than group_size."""
    jcfg, jp = _params(dtype)
    x = np.random.default_rng(0).normal(size=(B, S, D))
    _close(*_run(jcfg, jp, x, dtype), dtype)


def _route(jp, x):
    """Every token's first-choice expert under the router of `jp`."""
    logits = np.asarray(x, np.float32).reshape(-1, D) @ np.asarray(
        jp["router"])
    return logits.argmax(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overflowing_expert_drops_the_same_tokens(dtype):
    """A router that sends every token's first choice to expert 0: with
    16 tokens per group and capacity max(2, ceil(16*2/4*1.25)) = 10, six
    tokens of each group lose that assignment, in token order."""
    jcfg, jp = _params(dtype)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 0.5
    jp = {**jp, "router": jnp.asarray(router)}
    x = np.abs(np.random.default_rng(1).normal(size=(2, 32, D)))
    assert np.all(_route(jp, x) == 0)
    out, aux, ref, aux_r = _run(jcfg, jp, x, dtype)
    _close(out, aux, ref, aux_r, dtype)
    # the dropped tokens really changed the output: the same tokens with a
    # capacity large enough for all of them give another result
    big = dataclasses.replace(jcfg, capacity_factor=4.0)
    full, _, _, _ = _run(big, jp, x, dtype)
    assert float((full - out).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 1])
def test_tied_router_breaks_ties_to_the_lower_expert(dtype, k):
    """A zero router makes every probability 1/E: `lax.top_k` picks
    experts 0 and 1 (top-2), or expert 0 (top-1, llama4-maverick's
    routing), for every token, and so must the port (`torch.topk` is free
    to pick others). Those experts then overflow too."""
    jcfg, jp = _params(dtype, top_k=k)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = np.random.default_rng(2).normal(size=(2, 16, D))
    _close(*_run(jcfg, jp, x, dtype), dtype)
    vals, idx = tmoe.top_k(torch.full((3, 4), 0.25), k)
    assert idx.tolist() == [list(range(k))] * 3


@pytest.mark.parametrize("k", [2, 1])
def test_shared_expert(k):
    """The always-on shared expert added to the routed ones, also under
    llama4-maverick's top-1 routing. With the routed experts' down
    projections zeroed, the output is the shared expert's alone, on both
    sides."""
    jcfg, jp = _params("float32", shared_expert_ff=96, top_k=k)
    assert "shared" in jp
    x = np.random.default_rng(3).normal(size=(2, 16, D))
    _close(*_run(jcfg, jp, x, "float32"), "float32")
    jp = {**jp, "experts_down": jnp.zeros_like(jp["experts_down"])}
    out, aux, ref, aux_r = _run(jcfg, jp, x, "float32")
    _close(out, aux, ref, aux_r, "float32")
    shared = tmoe.apply_mlp(_to_torch(jp["shared"]),
                            torch.from_numpy(x).float(), "swiglu")
    assert float(shared.abs().max()) > 0
    torch.testing.assert_close(out, shared, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_experts_dequantize_as_the_reference(mode):
    """Quantized expert weights are dequantized to bf16 before the einsums
    (`_w`), on both sides; the router stays fp32."""
    jcfg, jp = _params("bfloat16")
    jq = jquantize_tree(jp, mode)
    assert set(jq["experts_up"]) == {"q", "scale"}
    x = np.random.default_rng(4).normal(size=(4, 16, D))
    _close(*_run(jcfg, jq, x, "bfloat16"), "bfloat16")


@pytest.mark.parametrize("B,S", [(4, 16), (8, 1)])
def test_grouped_gemm_path_matches_reference(monkeypatch, B, S):
    """The int8 experts' grouped-GEMM path (`moe._experts` through
    `kernels.moe_gemm`, whose plain version runs on the CPU), forced on
    for CPU tensors: within the bf16 tolerance of the reference, equal bit
    for bit to the `_w` + einsum path, and in `moe.gemm` spans (three a
    layer), with no `moe.dequant`."""
    from repro_torch import tracing
    jcfg, jp = _params("bfloat16")
    jq = jquantize_tree(jp, "int8")
    x = np.random.default_rng(5).normal(size=(B, S, D))
    tcfg = MoEConfig(**dataclasses.asdict(jcfg))
    xt = to_torch(np.asarray(jnp.asarray(x, jnp.bfloat16)))
    today, _ = tmoe.apply_moe(_to_torch(jq), xt, tcfg, "swiglu")
    monkeypatch.setattr(tmoe, "gemm_takes",
                        lambda dtype, device, sharded: dtype == torch.int8)
    tracing.drain()
    tracing.enable()
    try:
        out, aux, ref, aux_r = _run(jcfg, jq, x, "bfloat16")
    finally:
        tracing.disable()
    names = [sp.name for sp in tracing.drain()]
    assert names.count("moe.gemm") == 3 and "moe.dequant" not in names
    _close(out, aux, ref, aux_r, "bfloat16")
    assert torch.equal(out, today)


def test_group_size_must_divide_tokens():
    jcfg, jp = _params("float32")
    x = torch.zeros(3, 7, D)               # 21 tokens, groups of 16
    with pytest.raises(ValueError, match="must divide"):
        tmoe.apply_moe(_to_torch(jp), x, MoEConfig(**CFG), "swiglu")


def test_init_moe_shapes_and_scale():
    cfg = MoEConfig(**CFG, shared_expert_ff=32)
    p = tmoe.init_moe(D, cfg, "swiglu", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert p["router"].shape == (D, 4) and p["router"].dtype == torch.float32
    assert p["experts_up"].shape == (4, D, 128)
    assert p["experts_gate"].shape == (4, D, 128)
    assert p["experts_down"].shape == (4, 128, D)
    assert p["experts_down"].dtype == torch.bfloat16
    assert set(p["shared"]) == {"gate", "up", "down"}
    assert abs(float(p["experts_up"].float().std()) - 0.02) < 2e-3
