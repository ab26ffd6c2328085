"""The port's selective scan and Mamba block against the reference.

The scan's plain version (`repro_torch.kernels.ssm_scan`) is held to the
reference's jnp oracle `ssm_scan_ref`, its Pallas kernel in interpret
mode (as tests/test_kernels.py runs it) and the model's
`mamba_scan_ref`, at atol 1e-4, the tolerance of tests/test_kernels.py:
all are the same fp32 recurrence, so they differ by rounding only.
`apply_mamba` and `mamba_decode_step` run on the same converted weights
on both sides. Inputs come from a numpy seed. The CUDA kernel's own
arithmetic (exp2 of dt times a prescaled A), written in plain torch, is
held to the oracle by `fp32_gate`, the gate the card's checks use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_scan_ref
from repro.models import ssm as jssm
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import fp32_gate
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models import ssm as tssm
from repro_torch.weights import to_torch

ATOL = 1e-4


def _inputs(seed, B, S, di, N, with_h0):
    """u, dt, B, C, A, D, h0 as numpy fp32, drawn as tests/test_kernels.py
    draws them (dt in [0.001, 0.1], A in -[0.5, 2])."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.normal(size=(B, S, di))),
            f(rng.uniform(0.001, 0.1, (B, S, di))),
            f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N))),
            f(-rng.uniform(0.5, 2.0, (di, N))), f(rng.normal(size=(di,))),
            f(rng.normal(size=(B, di, N))) if with_h0 else None)


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("B,S,di,N,with_h0", [
    (2, 64, 128, 16, False),
    (2, 64, 128, 16, True),
    (1, 37, 96, 4, True),       # ragged S
    (3, 1, 64, 16, True),       # one decode step
    (2, 130, 40, 8, False),     # ragged S and di
])
def test_plain_scan_matches_jnp_oracles(B, S, di, N, with_h0):
    args = _inputs(0, B, S, di, N, with_h0)
    y, h = ssm_scan(*_torch(args))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    for yr, hr in (jax_scan_ref(*jargs), jssm.mamba_scan_ref(*jargs)):
        _close(y, yr)
        _close(h, hr)


@pytest.mark.parametrize("B,S,di,N,chunk,bdi", [
    (2, 128, 256, 16, 64, 128),
    (1, 64, 128, 4, 32, 128),
    (3, 1, 128, 16, 1, 128),    # one decode step
])
def test_plain_scan_matches_pallas_interpret(B, S, di, N, chunk, bdi):
    args = _inputs(1, B, S, di, N, True)
    y, h = ssm_scan(*_torch(args))
    yk, hk = jax_ssm_scan(*[jnp.asarray(a) for a in args], use_kernel=True,
                          interpret=True, chunk=chunk, block_di=bdi)
    _close(y, yk)
    _close(h, hk)


def test_plain_scan_state_continuity():
    """Two halves with the carried state equal one scan
    (tests/test_kernels.py's check, on the port's plain version)."""
    u, dt, Bm, Cm, A, D, _ = _torch(_inputs(2, 1, 256, 256, 8, False))
    y_full, h_full = ssm_scan(u, dt, Bm, Cm, A, D)
    half = 128
    y1, h1 = ssm_scan(u[:, :half], dt[:, :half], Bm[:, :half], Cm[:, :half],
                      A, D)
    y2, h2 = ssm_scan(u[:, half:], dt[:, half:], Bm[:, half:], Cm[:, half:],
                      A, D, h1)
    _close(h2, h_full)
    _close(y2, y_full[:, half:])
    _close(y1, y_full[:, :half])


def _served_inputs(seed, B, S, di, N, with_h0):
    """`chip_smoke.check_ssm`'s distribution from a numpy seed: unit-normal
    u, B, C, D and h0, dt = softplus(unit normal), A = -(1..N) a channel."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.normal(size=(B, S, di))),
            f(np.logaddexp(0.0, rng.normal(size=(B, S, di)))),
            f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N))),
            f(-np.broadcast_to(np.arange(1, N + 1), (di, N))),
            f(rng.normal(size=(di,))),
            f(rng.normal(size=(B, di, N))) if with_h0 else None)


def _kernel_arithmetic(u, dt, Bm, Cm, A, D, h0):
    """The CUDA kernel's arithmetic (`csrc/ssm_scan.cu`) in plain torch,
    fp32: e^(dt A) as 2^(dt (A log2 e)) with A log2 e rounded to fp32
    once, h <- dA h + (dt u) B, and y as 4 partial sums over n mod 4,
    added pairwise, plus D u. The card fuses the update and the partial
    sums into FMAs and rounds its exp2 within 2 ulp, which this leaves
    out."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    a2 = A * torch.tensor(1.4426950408889634, dtype=torch.float32)
    h = torch.zeros((Bsz, di, N)) if h0 is None else h0.clone()
    ys = []
    for t in range(S):
        dd, uu = dt[:, t], u[:, t]
        dA = torch.exp2(dd[..., None] * a2)
        h = dA * h + (dd * uu)[..., None] * Bm[:, t, None, :]
        p = h * Cm[:, t, None, :]
        acc = [p[..., j] for j in range(4)]
        for n in range(4, N):
            acc[n % 4] = acc[n % 4] + p[..., n]
        ys.append((acc[0] + acc[1]) + (acc[2] + acc[3]) + D * uu)
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("draw", [_inputs, _served_inputs])
def test_kernel_arithmetic_matches_jnp_oracle_within_fp32_gate(draw, with_h0):
    """The kernel's exp2 of a prescaled A and its update order stay within
    `fp32_gate` of the reference's oracle at (2, 512, 256, 16): with the
    tests' slow decay (dt in [0.001, 0.1], the state remembers hundreds of
    steps) and with `check_ssm`'s inputs."""
    args = draw(4, 2, 512, 256, 16, with_h0)
    y, h = _kernel_arithmetic(*_torch(args))
    yr, hr = jax_scan_ref(*[None if a is None else jnp.asarray(a)
                            for a in args])
    assert fp32_gate(y, torch.from_numpy(np.asarray(yr))) <= 1
    assert fp32_gate(h, torch.from_numpy(np.asarray(hr))) <= 1


def test_cpu_dispatch_uses_the_plain_version_and_kernel_refuses_cpu():
    args = _torch(_inputs(3, 1, 8, 32, 4, True))
    n = ssm_scan_kernel.launches
    y, h = ssm_scan(*args)
    assert ssm_scan_kernel.launches == n
    assert y.shape == (1, 8, 32) and h.shape == (1, 32, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_kernel(*args)


def _mamba_pair(seed, d_model, d_state, dtype):
    """The reference's Mamba parameters and their conversion."""
    jcfg = JSSMConfig(d_state=d_state, d_conv=4, expand=2)
    tcfg = SSMConfig(d_state=d_state, d_conv=4, expand=2)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), d_model, jcfg,
                         jnp.dtype(dtype))
    tp = {k: to_torch(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("d_model,d_state", [(64, 4), (96, 16)])
def test_mamba_prefill_and_decode_match_reference(d_model, d_state):
    """f32 parameters: apply_mamba over a prompt, then three decode steps
    from the carried state, on both sides. Outputs and h agree to fp32
    rounding (1e-5); the conv state is stored in bf16 on both sides, so it
    may differ by one bf16 step where fp32 noise straddles a rounding
    boundary (2**-8 relative)."""
    jcfg, tcfg, jp, tp = _mamba_pair(5, d_model, d_state, "float32")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 24, d_model)).astype(np.float32)
    jout, jst = jssm.apply_mamba(jp, jnp.asarray(x), jcfg)
    tout, tst = tssm.apply_mamba(tp, torch.from_numpy(x), tcfg)

    def check(tout, tst, jout, jst):
        np.testing.assert_allclose(tout.numpy(), _np(jout), atol=1e-5)
        np.testing.assert_allclose(tst["h"].numpy(), _np(jst["h"]),
                                   atol=1e-5)
        assert tst["conv"].dtype == torch.bfloat16
        jc = _np(jst["conv"])
        np.testing.assert_allclose(tst["conv"].float().numpy(), jc,
                                   rtol=2 ** -8, atol=1e-6)

    check(tout, tst, jout, jst)
    for step in range(3):
        x1 = rng.normal(size=(3, 1, d_model)).astype(np.float32)
        jout, jst = jssm.mamba_decode_step(jp, jnp.asarray(x1), jst, jcfg)
        tout, tst = tssm.mamba_decode_step(tp, torch.from_numpy(x1), tst,
                                           tcfg)
        check(tout, tst, jout, jst)


def test_mamba_bf16_matches_reference_within_bf16_steps():
    """bf16 parameters and activations: both sides round the conv, the
    projections and the gate to bf16, but XLA may keep a fused chain in
    fp32 where PyTorch rounds each op, so the output and h agree to five
    bf16 steps (2**-8 each) of their largest value (seen: under one)."""
    jcfg, tcfg, jp, tp = _mamba_pair(7, 64, 4, "bfloat16")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    jout, jst = jssm.apply_mamba(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tout, tst = tssm.apply_mamba(tp, to_torch(np.asarray(
        jnp.asarray(x, jnp.bfloat16))), tcfg)
    scale = float(np.abs(_np(jout)).max())
    assert float(np.abs(tout.float().numpy() - _np(jout)).max()) \
        <= 5 * 2 ** -8 * scale
    hs = float(np.abs(_np(jst["h"])).max())
    assert float(np.abs(tst["h"].numpy() - _np(jst["h"])).max()) \
        <= 5 * 2 ** -8 * hs


def test_init_mamba_matches_reference_layout():
    cfg = SSMConfig(d_state=16, d_conv=4, expand=2)
    p = tssm.init_mamba(64, cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    jp = jssm.init_mamba(jax.random.PRNGKey(0), 64, JSSMConfig(), jnp.bfloat16)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == v.dtype.name, k
    for k in ("D", "dt_bias"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    # log(1..N): the two frameworks' fp32 log may differ by one ulp
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2e-7)
