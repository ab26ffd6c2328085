"""The port's model API against the reference's `repro.models`, on the CPU.

`forward`, `train_loss`, `prefill` and `decode_step` on the contiguous
cache, `encode`, `cache_spec`, `init_cache` and `abstract_cache`, and the
plain attention functions of `models.attention`. Both sides run
`reduced(arch, vocab=1024)` on the reference's parameters (drawn in JAX,
converted by `weights.params_from_jax`) and the same numpy-drawn batch;
caches are compared after `weights.cache_from_jax`. The port's prefill
and encoder run their attention in the flash op (its plain version here),
where the reference's run `jnp`: in f32 the two agree to fp32 rounding.

Tolerances. f32 parameters: the same greedy tokens at every step, each
side fed its own; logits, loss and fp32 cache leaves within 1e-5 of their
largest magnitude (seen: under 7e-7); a leaf stored in bf16 (K/V, Mamba's
conv) within one bf16 step, 2**-7 of its largest magnitude, since fp32
noise that straddles a rounding boundary stores the neighbouring value
(seen: 1.3e-5); Mamba's fp32 h within 1e-3, since it inherits such a
flip of conv through u at the next step (as `tests/test_torch_runner.py`
holds jamba's f32 states; seen: 1.6e-5). bf16 parameters, as the runner tests hold
bf16 (`tests/test_torch_runner.py::test_bf16_pools_match`): both sides fed
the reference's tokens, K/V within 0.02 (five bf16 steps at |K| < 1) and
at least 90% of greedy tokens equal; the prefill's flash op does not round
P to bf16 where the reference does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import abstract_cache as jabstract_cache
from repro.models import cache_spec as jcache_spec
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jprefill
from repro.models import train_loss as jtrain_loss
from repro.models import attention as jattn
from repro_torch.configs import reduced
from repro_torch.models import (abstract_cache, cache_spec, decode_step,
                                forward, init_cache, init_params, prefill,
                                train_loss)
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.weights import cache_from_jax, params_from_jax, to_torch

B, S, STEPS = 2, 16, 3
ARCHS = ["llama31-8b", "qwen3-30b-a3b", "jamba-v0.1-52b", "xlstm-350m",
         "whisper-base", "qwen2-vl-7b", "llama4-maverick-400b-a17b"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(ref, port) -> float:
    """Largest |port - ref| over the largest |ref|."""
    ref = _np(ref)
    return float(np.abs(port.float().numpy() - ref).max()) / max(
        float(np.abs(ref).max()), 1e-30)


def _setup(arch, dtype="float32", seed=7):
    jcfg = jax_reduced(arch, vocab=1024)
    tcfg = reduced(arch, vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg,
                         dtype=jnp.dtype(dtype))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)


def _batch(cfg, seed=0):
    """tokens and labels (B, S); whisper's frames (B, frontend_len, d);
    the VLM's first 4 positions as patches (B, 4, d). Both sides' dicts."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, 1000, (B, S)).astype(np.int32),
         "labels": rng.integers(0, 1000, (B, S)).astype(np.int32)}
    if cfg.encoder_layers:
        b["frames"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        b["patches"] = rng.normal(size=(B, 4, cfg.d_model)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _cache_diffs(jcache, tcache, tcfg):
    """{(layer, leaf): (largest difference over the reference's largest
    magnitude, the leaf's dtype)} and the largest absolute K/V
    difference."""
    ref = cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg)
    assert torch.equal(ref["len"], tcache["len"])
    rel, kv = {}, 0.0
    for i, (a, b) in enumerate(zip(ref["layers"], tcache["layers"])):
        assert set(a) == set(b), i
        for n in a:
            assert a[n].shape == b[n].shape and a[n].dtype == b[n].dtype
            d = (a[n].float() - b[n].float()).abs().max()
            rel[i, n] = (float(d) / max(float(a[n].float().abs().max()),
                                        1e-30), a[n].dtype)
            if n in ("k", "v"):
                kv = max(kv, float(d))
    return rel, kv


def _decode_run(arch, dtype, feed_from_jax):
    """prefill (max_len S + STEPS) then STEPS decode steps on both sides.
    Returns per call (reference logits, port logits, cache diffs, K/V
    diff) and the token streams."""
    jcfg, tcfg, jp, tp = _setup(arch, dtype)
    jb, tb = _batch(jcfg)
    calls, toks = [], []
    lj, cj = jprefill(jp, jcfg, jb, max_len=S + STEPS)
    lt, ct = prefill(tp, tcfg, tb, max_len=S + STEPS)
    for step in range(STEPS + 1):
        calls.append((lj, lt) + _cache_diffs(cj, ct, tcfg))
        nj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        nt = torch.argmax(lt[:, -1], -1).to(torch.int32)
        toks.append((np.asarray(nj), nt.numpy()))
        if step == STEPS:
            break
        tt = torch.from_numpy(np.array(nj)) if feed_from_jax else nt
        lj, cj = jdecode_step(jp, jcfg, nj[:, None], cj)
        lt, ct = decode_step(tp, tcfg, tt[:, None], ct)
    return calls, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_loss_f32(arch):
    """f32: the full-sequence logits and the MoE aux loss within 1e-5,
    the loss and its parts too, with and without remat."""
    jcfg, tcfg, jp, tp = _setup(arch)
    jb, tb = _batch(jcfg)
    lj, aj = jforward(jp, jcfg, jb)
    lt, at = forward(tp, tcfg, tb)
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    assert _rel(lj, lt) <= 1e-5
    assert abs(float(aj) - float(at)) <= 1e-5 * max(1.0, abs(float(aj)))
    Lj, partsj = jtrain_loss(jp, jcfg, jb, remat=False)
    for remat in (False, True):
        Lt, partst = train_loss(tp, tcfg, tb, remat=remat)
        assert abs(float(Lt) - float(Lj)) <= 1e-5 * float(Lj)
        for n in ("ce", "aux"):
            assert abs(float(partst[n]) - float(partsj[n])) <= \
                1e-5 * max(1.0, abs(float(partsj[n])))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_f32(arch):
    """f32, each side fed its own tokens: the same greedy tokens after the
    prefill and each of 3 decode steps; the logits and every fp32 cache
    leaf within 1e-5 of their largest magnitude, a bf16 one within one
    bf16 step."""
    calls, toks = _decode_run(arch, "float32", feed_from_jax=False)
    for a, b in toks:
        np.testing.assert_array_equal(a, b)
    for lj, lt, rel, _ in calls:
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _rel(lj, lt) <= 1e-5
        for (i, n), (d, dt) in rel.items():
            tol = (2 ** -7 if dt == torch.bfloat16
                   else 1e-3 if (i, "conv") in rel else 1e-5)
            assert d <= tol, (i, n, d)


@pytest.mark.parametrize("arch", ["llama31-8b", "jamba-v0.1-52b",
                                  "whisper-base", "qwen2-vl-7b"])
def test_prefill_and_decode_bf16(arch):
    """bf16, both sides fed the reference's tokens: K/V within 0.02 after
    every call, and at least 90% of greedy tokens equal."""
    calls, toks = _decode_run(arch, "bfloat16", feed_from_jax=True)
    assert max(kv for *_, kv in calls) <= 0.02
    agree = np.mean(np.concatenate([a == b for a, b in toks]))
    assert agree >= 0.9, agree


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_agrees_with_forward(arch):
    """The port's own consistency, as `tests/test_models.py` holds the
    reference's: the prefill's last-position logits (flash op) give the
    full forward's (plain attention) greedy token, f32."""
    tcfg = reduced(arch)
    params = init_params(tcfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
    _, tb = _batch(tcfg)
    tb = {k: v for k, v in tb.items() if k != "labels"}
    tb["tokens"] = tb["tokens"] % tcfg.vocab_size
    full, _ = forward(params, tcfg, tb)
    pre, _ = prefill(params, tcfg, tb, max_len=S + 4)
    assert torch.equal(full[:, -1].argmax(-1), pre[:, -1].argmax(-1))
    assert float((full[:, -1] - pre[:, -1]).abs().max()) <= \
        1e-5 * float(full[:, -1].abs().max())


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "float8_e4m3fn": torch.float8_e4m3fn}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_abstract_cache_unstack_the_reference(arch):
    """Layer r * U + j of the port's cache has the shape and dtype of
    repeat r of the reference's unit position j, K/V in
    `PERF.kv_cache_dtype`; `abstract_cache` on the meta device;
    `init_cache` zeros, equal to the reference's converted."""
    jcfg, tcfg = jax_reduced(arch, vocab=1024), reduced(arch, vocab=1024)
    enc = jcfg.frontend_len if jcfg.encoder_layers else 0
    jspec = jcache_spec(jcfg, B, 24, enc)
    tspec = cache_spec(tcfg, B, 24, enc)
    jabs = jabstract_cache(jcfg, B, 24, enc)
    tabs = abstract_cache(tcfg, B, 24, enc)
    assert tspec["len"] == ((B,), torch.int32)
    U = len(jspec["blocks"])
    assert len(tspec["layers"]) == tcfg.num_layers
    for i, (leaves, meta) in enumerate(zip(tspec["layers"],
                                           tabs["layers"])):
        ref, ref_abs = jspec["blocks"][i % U], jabs["blocks"][i % U]
        assert set(leaves) == set(ref) == set(meta), i
        for n, (shape, dt) in leaves.items():
            assert shape == ref[n][0][1:], (i, n)
            assert dt == DTYPES[jnp.dtype(ref[n][1]).name], (i, n)
            assert meta[n].device.type == "meta"
            assert meta[n].shape == ref_abs[n].shape[1:]
            assert meta[n].dtype == dt
    zeros = init_cache(tcfg, B, 24, enc)
    ref = cache_from_jax(jax.tree.map(np.asarray,
                                      jinit_cache(jcfg, B, 24, enc)), tcfg)
    for a, b in zip(ref["layers"], zeros["layers"]):
        for n in a:
            assert torch.equal(a[n], b[n]) and a[n].dtype == b[n].dtype


def test_kv_cache_dtype_is_kept():
    """`PERF.kv_cache_dtype` fp8: the prefill stores K/V in e4m3, decode
    reads them back in the activations' dtype, as the reference does."""
    jcfg, tcfg, jp, tp = _setup("llama31-8b")
    jb, tb = _batch(jcfg)
    from repro.models import model as jmodel
    old_j, old_t = jmodel.PERF.kv_cache_dtype, tmodel.PERF.kv_cache_dtype
    jmodel.PERF.kv_cache_dtype = jnp.float8_e4m3fn
    tmodel.PERF.kv_cache_dtype = torch.float8_e4m3fn
    try:
        lj, cj = jprefill(jp, jcfg, jb, max_len=S + 1)
        lt, ct = prefill(tp, tcfg, tb, max_len=S + 1)
        assert ct["layers"][0]["k"].dtype == torch.float8_e4m3fn
        assert cache_spec(tcfg, B, 8)["layers"][0]["k"][1] == \
            torch.float8_e4m3fn
        tok = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)[:, None]
        lj, cj = jdecode_step(jp, jcfg, tok, cj)
        lt, ct = decode_step(tp, tcfg, torch.from_numpy(np.array(tok)), ct)
    finally:
        jmodel.PERF.kv_cache_dtype = old_j
        tmodel.PERF.kv_cache_dtype = old_t
    rel, _ = _cache_diffs(cj, ct, tcfg)
    for (i, n), (d, dt) in rel.items():     # e4m3 K/V: one step, 2**-3
        assert d <= (2 ** -3 if dt == torch.float8_e4m3fn else 1e-5), (i, n)
    assert _rel(lj, lt) <= 1e-3


# ---------------------------------------------------------------------------
# The plain attention functions
# ---------------------------------------------------------------------------

def _qkv(seed, dtype, Sq, Sk, Hq=8, Hkv=2, D=16, Bq=2):
    rng = np.random.default_rng(seed)
    mk = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32), dtype)
    q, k, v = mk(Bq, Sq, Hq, D), mk(Bq, Sk, Hkv, D), mk(Bq, Sk, Hkv, D)
    return (q, k, v), tuple(to_torch(np.asarray(t)) for t in (q, k, v))


# f32: the same products summed in another order; bf16: one bf16 step of
# the output (both sides round scores, P and the output to bf16 alike)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_and_bidirectional_attention(dtype):
    """`causal_attention` (also with `q_offset` and a `kv_len` padding
    mask, a 0 among them) and `bidirectional_attention` (Sq != Sk)."""
    tol = ATTN_TOL[dtype]
    (q, k, v), (tq, tk, tv) = _qkv(0, dtype, 24, 24)
    assert _rel(jattn.causal_attention(q, k, v),
                tattn.causal_attention(tq, tk, tv)) <= tol
    kv_len = np.array([24, 7], np.int32)
    assert _rel(jattn.causal_attention(q, k, v, kv_len=jnp.asarray(kv_len)),
                tattn.causal_attention(tq, tk, tv,
                                       kv_len=torch.from_numpy(kv_len))
                ) <= tol
    (q, k, v), (tq, tk, tv) = _qkv(1, dtype, 8, 24)
    assert _rel(jattn.causal_attention(q, k, v, q_offset=16),
                tattn.causal_attention(tq, tk, tv, q_offset=16)) <= tol
    assert _rel(jattn.bidirectional_attention(q, k, v),
                tattn.bidirectional_attention(tq, tk, tv)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_chunked(dtype):
    """The online-softmax blocks (4 x 4 blocks of 16) against the
    reference's, and against the unblocked causal attention."""
    (q, k, v), (tq, tk, tv) = _qkv(2, dtype, 64, 64)
    out = tattn.causal_attention_chunked(tq, tk, tv, block_q=16, block_k=16)
    assert _rel(jattn.causal_attention_chunked(q, k, v, block_q=16,
                                               block_k=16), out) \
        <= ATTN_TOL[dtype]
    if dtype == "float32":
        assert _rel(jattn.causal_attention(q, k, v), out) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_and_partial(dtype):
    """`decode_attention` over a contiguous (B, Hkv, S, D) cache with
    per-slot lengths; `decode_attention_partial` on a shard where one
    slot has no valid key (m -inf, denominator 0), and the exact combine
    of two shards equal to the whole."""
    rng = np.random.default_rng(3)
    mk = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32), dtype)
    q, kc, vc = mk(3, 1, 8, 16), mk(3, 2, 32, 16), mk(3, 2, 32, 16)
    tq, tk, tv = (to_torch(np.asarray(t)) for t in (q, kc, vc))
    lens = np.array([32, 5, 17], np.int32)
    tol = ATTN_TOL[dtype]
    ref = jattn.decode_attention(q, kc, vc, jnp.asarray(lens))
    out = tattn.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert _rel(ref, out) <= tol
    valid = np.arange(32)[None] < lens[:, None]
    parts = []
    for half in (slice(0, 16), slice(16, 32)):
        mask = valid[:, half]
        rj = jattn.decode_attention_partial(q, kc[:, :, half], vc[:, :, half],
                                            jnp.asarray(mask))
        rt = tattn.decode_attention_partial(tq, tk[:, :, half],
                                            tv[:, :, half],
                                            torch.from_numpy(mask))
        for a, b in zip(rj, rt):
            a = np.asarray(a)
            finite = np.isfinite(a)
            np.testing.assert_array_equal(finite, torch.isfinite(b).numpy())
            np.testing.assert_allclose(b.numpy()[finite], a[finite],
                                       rtol=tol, atol=tol)
        parts.append(rt)
    assert torch.isneginf(parts[1][2][1]).all()       # slot 1: 5 keys
    (n0, d0, m0), (n1, d1, m1) = parts
    m = torch.maximum(m0, m1)
    w0 = torch.where(torch.isfinite(m0), torch.exp(m0 - m), 0.0)
    w1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m), 0.0)
    whole = (n0 * w0 + n1 * w1) / (d0 * w0 + d1 * w1)
    assert _rel(ref, whole) <= (1e-5 if dtype == "float32" else 2 ** -6)


def test_update_and_fill_cache():
    """One decode step's K/V written at each slot's index, and a prefill
    written into the head of the cache; the given caches untouched."""
    rng = np.random.default_rng(4)
    kc = rng.normal(size=(3, 2, 8, 4)).astype(np.float32)
    vc = rng.normal(size=(3, 2, 8, 4)).astype(np.float32)
    kn = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    vn = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    idx = np.array([0, 7, 3], np.int32)
    t = lambda a: torch.from_numpy(a.copy())
    tk, tv = t(kc), t(vc)
    rk, rv = jattn.update_cache(*(jnp.asarray(a) for a in (kc, vc, kn, vn)),
                                jnp.asarray(idx))
    ok, ov = tattn.update_cache(tk, tv, t(kn), t(vn), t(idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tk.numpy(), kc)
    kp = rng.normal(size=(3, 5, 2, 4)).astype(np.float32)
    rk, rv = jattn.fill_cache(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(kp), jnp.asarray(kp))
    ok, ov = tattn.fill_cache(tk, tv, t(kp), t(kp))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))


def test_models_exports_the_reference_api():
    import repro_torch.models as tm
    for name in ("forward", "prefill", "decode_step", "train_loss", "encode",
                 "init_cache", "cache_spec", "abstract_cache", "init_params"):
        assert callable(getattr(tm, name)), name
