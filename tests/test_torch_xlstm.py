"""The port's xLSTM blocks and tied unembedding against the reference.

`mlstm_seq` and `slstm_seq` run on the reference's parameters, converted
by `weights.to_torch` (int8 matrices stored K-major, as
`weights.params_from_jax` stores them), and on the same numpy-drawn
inputs, from a fresh state and from a carried one. Tolerances, each over
the largest magnitude of the compared tensor: f32 1e-5 (the same fp32
recurrence, its products summed in another order); bf16 outputs 2**-7
(two bf16 steps: both sides round every projection, the normalised h and
the gated product to bf16, and may land on neighbouring values), bf16
states 2**-8 (they are fp32, fed by bf16 projections that agree but for
rare one-step flips). Under int8 each projection quantizes its input per
tensor, so a bf16 flip of one input element can become a flipped int8
step, 1/127 of the input's largest value: outputs within 2/127.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import XLSTMConfig as JXLSTMConfig
from repro.models import init_params as jax_init_params
from repro.models import model as jmodel
from repro.models import xlstm as jxlstm
from repro.quant import BY_NAME as JBY_NAME
from repro.quant import quantize_tree as jquantize_tree
from repro_torch.configs import reduced
from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import init_params
from repro_torch.models import model as tmodel
from repro_torch.models import xlstm as txlstm
from repro_torch.quant import BY_NAME
from repro_torch.weights import _stored, params_from_jax, to_torch

D, H = 64, 4
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -8)}


def _convert(tree):
    if isinstance(tree, dict):
        return _stored({k: _convert(v) for k, v in tree.items()})
    return None if tree is None else to_torch(np.asarray(tree))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(port, ref) -> float:
    """Largest |port - ref| over the largest |ref|."""
    ref = _np(ref)
    return float(np.abs(port.float().numpy() - ref).max()) / max(
        float(np.abs(ref).max()), 1e-30)


def _inputs(seed, dtype, S):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(3, S, D)).astype(np.float32), dtype)
    return x, to_torch(np.asarray(x))


def _check(y, st, jy, jst, dtype, y_tol=None):
    y_tol, st_tol = y_tol or TOL[dtype][0], TOL[dtype][1]
    assert y.dtype == (torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    assert _rel(y, jy) <= y_tol
    assert set(st) == set(jst)
    for n, v in st.items():
        assert v.dtype == torch.float32, n
        assert _rel(v, jst[n]) <= st_tol, (n, _rel(v, jst[n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_seq_matches_reference(dtype):
    """A 12-step sequence from a fresh state (m = -inf), then 3 single
    steps from the carried state, as prefill and decode run them."""
    jp = jxlstm.init_mlstm(jax.random.PRNGKey(1), D, H, JXLSTMConfig(),
                           jnp.dtype(dtype))
    tp = _convert(jp)
    xj, xt = _inputs(0, dtype, 12)
    jy, jst = jxlstm.mlstm_seq(jp, xj, H, JXLSTMConfig())
    y, st = txlstm.mlstm_seq(tp, xt, H, XLSTMConfig())
    _check(y, st, jy, jst, dtype)
    for step in range(3):
        xj, xt = _inputs(10 + step, dtype, 1)
        carried = {n: v.clone() for n, v in st.items()}
        jy, jst = jxlstm.mlstm_seq(jp, xj, H, JXLSTMConfig(), jst)
        y, st = txlstm.mlstm_seq(tp, xt, H, XLSTMConfig(), carried)
        _check(y, st, jy, jst, dtype)


@pytest.mark.parametrize("dtype,quant", [("float32", None),
                                         ("bfloat16", None),
                                         ("bfloat16", "int8"),
                                         ("bfloat16", "fp8")])
def test_slstm_seq_matches_reference(dtype, quant):
    """As above for the sLSTM block; with `quant` every matrix is
    quantized, `slstm_wr` included, which both sides dequantize to bf16
    (`q.astype(bf16) * scale.astype(bf16)`) before the fp32 recurrent
    product, and the projections go through `linear` in that mode."""
    jp = jxlstm.init_slstm(jax.random.PRNGKey(2), D, JXLSTMConfig(),
                           jnp.dtype(dtype))
    jq = tq = y_tol = None
    if quant == "int8":
        y_tol = 2 / 127                 # seen: 0.0102
    if quant:
        jp = jquantize_tree(jp, quant)
        jq, tq = JBY_NAME[quant], BY_NAME[quant]
        assert isinstance(jp["slstm_wr"], dict)
    tp = _convert(jp)
    xj, xt = _inputs(0, dtype, 12)
    jy, jst = jxlstm.slstm_seq(jp, xj, JXLSTMConfig(), qcfg=jq)
    y, st = txlstm.slstm_seq(tp, xt, XLSTMConfig(), qcfg=tq)
    _check(y, st, jy, jst, dtype, y_tol)
    for step in range(3):
        xj, xt = _inputs(10 + step, dtype, 1)
        carried = {n: v.clone() for n, v in st.items()}
        jy, jst = jxlstm.slstm_seq(jp, xj, JXLSTMConfig(), jst, qcfg=jq)
        y, st = txlstm.slstm_seq(tp, xt, XLSTMConfig(), carried, qcfg=tq)
        _check(y, st, jy, jst, dtype, y_tol)


def test_blocks_read_their_state_and_never_write_it():
    """The runner keeps the pooled state of inactive slots by masking
    against it after the block has run, so a block must not write it."""
    tp = _convert(jxlstm.init_mlstm(jax.random.PRNGKey(3), D, H,
                                    JXLSTMConfig(), jnp.float32))
    sp = _convert(jxlstm.init_slstm(jax.random.PRNGKey(4), D,
                                    JXLSTMConfig(), jnp.float32))
    _, xt = _inputs(5, "float32", 2)
    for fn, state in (
            (lambda s: txlstm.mlstm_seq(tp, xt, H, XLSTMConfig(), s),
             txlstm.init_mlstm_state(3, D, H, XLSTMConfig(), device="cpu")),
            (lambda s: txlstm.slstm_seq(sp, xt, XLSTMConfig(), s),
             txlstm.init_slstm_state(3, D, device="cpu"))):
        before = {n: v.clone() for n, v in state.items()}
        _, new = fn(state)
        for n, v in state.items():
            assert torch.equal(v, before[n]), n
            assert not torch.equal(new[n], v), n


def _leaves(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _leaves(t, f"{path}/{n}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_init_matches_reference_layout():
    """Parameter names, shapes and dtypes of both blocks and their states,
    and the initial states' values (mLSTM m = -inf, sLSTM n = 1)."""
    gen = torch.Generator().manual_seed(0)
    pairs = [
        (txlstm.init_mlstm(D, H, XLSTMConfig(), device="cpu", generator=gen),
         jxlstm.init_mlstm(jax.random.PRNGKey(0), D, H, JXLSTMConfig())),
        (txlstm.init_slstm(D, XLSTMConfig(), device="cpu", generator=gen),
         jxlstm.init_slstm(jax.random.PRNGKey(0), D, JXLSTMConfig())),
        (txlstm.init_mlstm_state(3, D, H, XLSTMConfig(), device="cpu"),
         jxlstm.init_mlstm_state(3, D, H, JXLSTMConfig())),
        (txlstm.init_slstm_state(3, D, device="cpu"),
         jxlstm.init_slstm_state(3, D))]
    for port, ref in pairs:
        assert _leaves(port) == _leaves(ref)
    for port, ref in pairs[2:]:
        for n, v in port.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_unembed_matches_reference(dtype):
    """Tied embeddings: fp32 logits of x against `embed`, as the
    reference's `dot_general(preferred_element_type=float32)`; bf16 inputs
    multiply exactly in fp32, so both agree to fp32 summation order, 1e-5
    of the largest logit (a bf16 product rounded to bf16 would miss by
    2**-9 of it)."""
    jcfg = jax_reduced("xlstm-350m", vocab=1024)
    tcfg = reduced("xlstm-350m", vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.dtype(dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    assert "lm_head" not in jp and "lm_head" not in tp
    xj, xt = _inputs(6, dtype, 2)
    ref = jmodel.unembed(jp, jcfg, xj)
    out = tmodel.unembed(tp, tcfg, xt)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(out, ref) <= 1e-5


def test_init_params_tied_and_quantized():
    """The port's own xLSTM parameters: no lm_head, ln1 and the block's
    parameters per layer (no ln2 or MLP), int8 matrices K-major."""
    cfg = reduced("xlstm-350m", vocab=1024, layers=4)
    p = init_params(cfg, device="cpu", quant="int8",
                    generator=torch.Generator().manual_seed(0))
    assert "lm_head" not in p and p["embed"].dtype == torch.bfloat16
    kinds = [("mlstm_up" in lp, "slstm_wr" in lp) for lp in p["layers"]]
    assert kinds == [(True, False), (False, True)] * 2
    for lp in p["layers"]:
        assert "ln2" not in lp and "mlp" not in lp and "ln1" in lp
    wr = p["layers"][1]["slstm_wr"]["q"]
    assert wr.dtype == torch.int8
    assert wr.stride() == (1, -(-wr.shape[0] // 16) * 16)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_params_and_pools_from_jax_xlstm(mode):
    """xLSTM layers arrive under the reference's flat names, bit for bit
    (int8 matrices K-major), with no lm_head; the reference's stacked
    mLSTM/sLSTM serving state is cut per layer by `pools_from_jax`, -inf
    stabiliser included. The full configs are the reference's."""
    from repro.configs import get_config as jget_config
    from repro.serving.runner import init_pools as jinit_pools
    from repro_torch.configs import get_config
    from repro_torch.serving.runner import init_pools
    from repro_torch.weights import pools_from_jax
    jcfg = jax_reduced("xlstm-350m", vocab=1024, layers=4)
    tcfg = reduced("xlstm-350m", vocab=1024, layers=4)
    jp = jquantize_tree(jax_init_params(jax.random.PRNGKey(0), jcfg), mode)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    assert "lm_head" not in tp
    U = len(jp["blocks"])
    for i, layer in enumerate(tp["layers"]):
        blk, r = jp["blocks"][i % U], i // U
        assert set(layer) == set(blk)
        for n, a in blk.items():
            if n in ("ln1", "mlstm_norm"):
                a, t = a["scale"], layer[n]["scale"]
            elif mode == "int8":
                a, t = a["q"], layer[n]["q"]
                assert t.stride() == (1, -(-t.shape[0] // 16) * 16), n
            else:
                t = layer[n]
            np.testing.assert_array_equal(
                t.view(torch.int8 if t.dtype == torch.int8 else torch.int16)
                .numpy(), np.asarray(a[r]).view(
                    np.int8 if t.dtype == torch.int8 else np.int16))
    jpools = pools_from_jax(jax.tree.map(np.asarray, jinit_pools(
        jcfg, 8, 4, 3)), tcfg)
    tpools = init_pools(tcfg, 8, 4, 3, device="cpu")
    assert _leaves({str(i): p for i, p in enumerate(jpools)}) == \
        _leaves({str(i): p for i, p in enumerate(tpools)})
    for j, t in zip(jpools, tpools):
        for n, v in t.items():
            np.testing.assert_array_equal(v.numpy(), j[n].numpy())
    assert tpools[0]["C"].shape == (3, 4, 32, 32)
    for name in ("mixtral-8x7b", "xlstm-350m"):
        assert repr(get_config(name)) == repr(jget_config(name))
