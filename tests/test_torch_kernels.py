"""The port's plain kernel versions against the reference's Pallas
kernels (run in interpret mode on the CPU) and its jnp oracles.

The inputs are drawn with numpy from a seed and handed to both sides.
Tolerances are those of tests/test_kernels.py: 2e-3 in f32 (fp32 softmax
in both, summed in a different order) and 0.06 in bf16 (the output is
rounded to bf16 by both, and the jnp oracles also round the softmax
probabilities to bf16 before the PV product). The int8 matmul is exact:
an int32 sum and the same fp32 conversion and multiply on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_fref
from repro.kernels.int8_matmul.ops import int8_matmul as jax_int8_matmul
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_int8_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_pref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.weights import to_torch

TOL = {"bfloat16": 0.06, "float32": 2e-3}


def _pair(rng, shape, dtype):
    """The same random array for JAX and for the port."""
    a = jnp.asarray(rng.normal(size=shape), dtype)
    return a, to_torch(np.asarray(a))


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=tol)


FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True),
    (1, 128, 256, 8, 8, 128, False),
    (2, 256, 256, 4, 1, 64, True),       # MQA
    (1, 512, 512, 2, 2, 32, True),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_matches_pallas_and_oracle(B, Sq, Sk, Hq, Hkv, D, causal,
                                               dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, (B, Sq, Hq, D), dtype), _pair(rng, (B, Sk, Hkv, D), dtype),
        _pair(rng, (B, Sk, Hkv, D), dtype))
    out = flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, jax_flash(qj, kj, vj, causal=causal, use_kernel=True,
                          interpret=True), TOL[dtype])
    _close(out, jax_fref(qj, kj, vj, causal=causal), TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_ragged_length(dtype):
    """Sq = Sk = 192: a multiple of 64 but not of 128, which the Pallas
    kernel's divisibility assert refuses; held against the oracle only."""
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, (2, 192, 4, 64), dtype), _pair(rng, (2, 192, 2, 64), dtype),
        _pair(rng, (2, 192, 2, 64), dtype))
    _close(flash_attention(qt, kt, vt, causal=True),
           jax_fref(qj, kj, vj, causal=True), TOL[dtype])


def _paged_inputs(rng, B, Hq, Hkv, D, page, maxp, P, dtype="bfloat16"):
    qj, qt = _pair(rng, (B, Hq, D), dtype)
    (kj, kt), (vj, vt) = (_pair(rng, (P, page, Hkv, D), dtype),
                          _pair(rng, (P, page, Hkv, D), dtype))
    bt = rng.choice(P, size=(B, maxp), replace=B * maxp > P).astype(np.int32)
    return (qj, kj, vj, jnp.asarray(bt)), (qt, kt, vt, torch.from_numpy(bt))


@pytest.mark.parametrize("B,Hq,Hkv,D,page,maxp,P", [
    (2, 4, 2, 64, 8, 4, 16),
    (3, 8, 1, 128, 16, 3, 64),
    (1, 4, 4, 64, 8, 6, 12),
    (4, 8, 2, 64, 8, 5, 64),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_plain_matches_pallas_and_oracle(B, Hq, Hkv, D, page, maxp, P,
                                               dtype):
    rng = np.random.default_rng(2)
    (qj, kj, vj, btj), (qt, kt, vt, btt) = _paged_inputs(
        rng, B, Hq, Hkv, D, page, maxp, P, dtype)
    sl = rng.integers(1, page * maxp + 1, size=(B,)).astype(np.int32)
    out = paged_attention(qt, kt, vt, btt, torch.from_numpy(sl))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    slj = jnp.asarray(sl)
    _close(out, jax_paged(qj, kj, vj, btj, slj, use_kernel=True,
                          interpret=True), TOL[dtype])
    _close(out, jax_pref(qj, kj, vj, btj, slj), TOL[dtype])


def test_paged_zero_length_gives_zero_like_the_kernel():
    """seq_len 0 (every inactive decode slot): the Pallas kernel and the
    port give exactly 0; the rows with context agree as above."""
    rng = np.random.default_rng(3)
    (qj, kj, vj, btj), (qt, kt, vt, btt) = _paged_inputs(
        rng, 3, 8, 2, 64, 8, 4, 16)
    sl = np.array([0, 5, 0], np.int32)
    out = paged_attention(qt, kt, vt, btt, torch.from_numpy(sl))
    pallas = np.asarray(jax_paged(qj, kj, vj, btj, jnp.asarray(sl),
                                  use_kernel=True, interpret=True),
                        np.float32)
    assert torch.all(out[[0, 2]] == 0)
    assert np.all(pallas[[0, 2]] == 0)
    _close(out, pallas, TOL["bfloat16"])


@pytest.mark.parametrize("M,K,N", [(256, 256, 256), (512, 512, 256),
                                   (256, 1024, 512)])
def test_int8_matmul_plain_equals_pallas_and_oracle(M, K, N):
    """The shapes of tests/test_kernels.py; equality, not a tolerance."""
    rng = np.random.default_rng(4)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = np.asarray([0.013], np.float32)
    ws = rng.uniform(0.001, 0.02, (1, N)).astype(np.float32)
    out = int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, xs, ws)))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    jargs = [jnp.asarray(a) for a in (xq, wq, xs, ws)]
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_int8_matmul(*jargs, use_kernel=True,
                                                interpret=True)))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax_int8_ref(*jargs)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_kv_len_matches_reference_attention(causal):
    """With `kv_len`, the plain version masks keys at or past each
    sequence's length as the reference model's prefill attention does
    (`causal_attention(kv_len=)`, f32), including a sequence with
    kv_len 0, which both give the mean of V over all keys."""
    from repro.models.attention import causal_attention
    rng = np.random.default_rng(4)
    B, S, Hq, Hkv, D = 4, 70, 4, 2, 16
    q, tq = _pair(rng, (B, S, Hq, D), jnp.float32)
    k, tk = _pair(rng, (B, S, Hkv, D), jnp.float32)
    v, tv = _pair(rng, (B, S, Hkv, D), jnp.float32)
    lens = np.array([5, 0, 70, 33], np.int32)
    if causal:
        ref = causal_attention(q, k, v, kv_len=jnp.asarray(lens))
    else:                  # the reference's mask without the causal part
        ref = causal_attention(q, k, v, q_offset=S,
                               kv_len=jnp.asarray(lens))
    out = flash_attention(tq, tk, tv, causal=causal,
                          kv_len=torch.from_numpy(lens))
    _close(out, ref, 1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(
        np.repeat(np.asarray(v[1]).mean(0), Hq // Hkv, axis=0),
        (S, Hq, D)), atol=1e-5)
