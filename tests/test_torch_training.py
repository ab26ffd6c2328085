"""The port's training package against the reference's `repro.training`,
on the CPU (the fused 8-bit update through its plain version).

Tolerances, each with its reason:
- Data: tokens and labels equal as values (int64 against int32); frames
  and patches bf16 bit for bit.
- The 8-bit codec: codes and scales equal to `jax.jit` of `_q8`, the
  dequantized moments equal to `jax.jit` of `_dq8` (its `/ 127.0` is a
  product by fl32(1/127) there).
- `adamw8bit.update` fed the same parameters, state (`opt_state_from_jax`)
  and gradients as `jax.jit(opt.update)`, 5 steps: codes and scales bit
  for bit (the new moments depend only on the gradients and the old
  state, and the port fuses the same products as the compiled
  reference); bf16 parameters within one bf16 step, fp32 ones within 8
  fp32 ulps of their magnitude: XLA's CPU `rsqrt` is not correctly
  rounded and the port's `1 / sqrt` is, so u may differ by an ulp a step;
  where p - lr u nears 0 that ulp of u is larger than one of p, so lr ·
  2**-20 is added (an ulp of |u| <= 8, times lr; seen: 2.3e-10 at a
  parameter of 1.8e-8). `adamw` likewise: moments bit for bit,
  parameters as above (XLA's CPU sqrt is not always correctly rounded).
- Compression: bit for bit against `jax.jit`.
- One train step at f32 (reduced llama31-8b and qwen3-30b-a3b, the MoE's
  aux loss): loss, aux and grad norm within 1e-5 relative (the same
  forward; torch sums gradients and the norm in other orders), every
  parameter within lr / 3 (Adam's first step moves each by about lr,
  so a lost or reversed update fails) and their mean difference within
  1e-7 (seen: 1.6e-5 largest, 1.3e-9 mean). Later 8-bit steps are not
  held: a v code that rounds to 0 in one framework and not the other
  makes that element's update explode (seen: 12.6 at step 3), as the
  reference's own sqrt codec note warns.
- Checkpoints: bit for bit across the two packages, equal manifests.
"""
import importlib.util
import json
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.training import CheckpointManager as JCheckpointManager
from repro.training import SyntheticDataLoader as JSyntheticDataLoader
from repro.training import adamw as jadamw
from repro.training import adamw8bit as jadamw8bit
from repro.training import build_train_step as jbuild_train_step
from repro.training import compression as jcompression
from repro.training.optimizer import _dq8, _q8
from repro_torch.configs import reduced
from repro_torch.kernels.adamw8bit.ref import dequantize, quantize
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params
from repro_torch.training import (CheckpointManager, SyntheticDataLoader,
                                  adamw, adamw8bit, build_train_step,
                                  compress_int8, decompress_int8,
                                  error_feedback_update)
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.weights import opt_state_from_jax, params_from_jax, to_torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run thousands of small torch ops; with the suite's
    workers sharing the CPU, a thread pool per worker makes them wait on
    each other (25 training steps took 30x longer than in one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_torch(np.asarray(a))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.reshape(-1).view(torch.uint8) ==
         b.reshape(-1).view(torch.uint8)).all())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 7, 123])
def test_batches_equal_the_reference(step):
    kw = dict(vocab=1000, batch=3, seq=17, seed=5, frames=6, d_model=8,
              patches=4)
    ref = JSyntheticDataLoader(**kw).batch_at(step)
    got = SyntheticDataLoader(**kw).batch_at(step)
    assert sorted(got) == sorted(ref)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ("frames", "patches"):
        assert _bits_equal(got[k], _t(ref[k]))


def test_loader_iterates_from_step_zero():
    dl = SyntheticDataLoader(50, 2, 5, seed=1)
    first = next(iter(dl))
    assert torch.equal(first["tokens"], dl.batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# the 8-bit codec and the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (300,), (4, 256), (3, 5, 1365)])
def test_q8_codec_matches_the_jitted_reference(shape):
    r = np.random.default_rng(len(shape))
    x = (r.normal(size=shape) ** 3).astype(np.float32)
    jq, js = jax.jit(_q8, static_argnums=1)(x, 256)
    q, s = quantize(torch.from_numpy(x))
    assert torch.equal(q, _t(jq)) and torch.equal(s, _t(js))
    back = jax.jit(_dq8, static_argnums=2)(jq, js, 256)
    assert torch.equal(dequantize(q, s), _t(back))


# the reference's hypothesis property (`test_q8_codec_roundtrip_property`)
# as fixed cases: lengths across 1..4096, heavy-tailed values
@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (255, 2), (256, 3),
                                    (257, 4), (1000, 5), (1365, 6),
                                    (4096, 7), (3001, 2**31 - 1)])
def test_q8_codec_roundtrip_property(n, seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy((r.normal(size=(n,)) ** 3).astype(np.float32))
    q, s = quantize(x)
    back = dequantize(q, s)
    assert back.shape == x.shape
    absmax = float(x.abs().max())
    assert float((back - x).abs().max()) <= absmax * 0.02 + 1e-9


def _opt_setup(dtype, seed=0):
    """reduced llama31-8b parameters in `dtype`, both packages' trees."""
    jcfg = jax_reduced("llama31-8b", vocab=512)
    tcfg = reduced("llama31-8b", vocab=512)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg,
                         dtype=jnp.dtype(dtype))
    return tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


def _grads(jp, r, scale, dtype):
    return jax.tree.map(
        lambda p: jnp.asarray(r.normal(size=p.shape) * scale, dtype), jp)


def _within_steps(ref: torch.Tensor, got: torch.Tensor, ulps: int,
                  lr: float = 3e-3):
    """|got - ref| within `ulps` units of the last place of ref's dtype at
    each element's magnitude, plus lr · 2**-20 (one ulp of the update)."""
    eps = torch.finfo(ref.dtype).eps
    ref, got = ref.double(), got.double()
    tol = ulps * eps * ref.abs() + lr * 2.0 ** -20
    return bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("name,dtype,grad_dtype,clip,wd", [
    ("adamw8bit", "bfloat16", "bfloat16", None, 0.0),
    ("adamw8bit", "bfloat16", "bfloat16", 0.37, 0.0),
    ("adamw8bit", "bfloat16", "float32", 0.37, 0.1),   # accumulated grads
    ("adamw8bit", "float32", "float32", None, 0.1),
    ("adamw", "bfloat16", "bfloat16", 0.37, 0.0),
    ("adamw", "float32", "float32", None, 0.1),
])
def test_update_matches_the_jitted_reference(name, dtype, grad_dtype, clip,
                                             wd):
    """5 updates from the same parameters, state and gradients; with a
    clip scale the reference is fed `g * scale.astype(g.dtype)`, as its
    train step scales the gradients."""
    tcfg, jp, tp = _opt_setup(dtype)
    jopt = (jadamw8bit if name == "adamw8bit" else jadamw)(
        3e-3, weight_decay=wd)
    topt = (adamw8bit if name == "adamw8bit" else adamw)(
        3e-3, weight_decay=wd)
    js = jopt.init(jp)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg)
    upd = jax.jit(jopt.update)
    r = np.random.default_rng(1)
    gdt = jnp.dtype(grad_dtype)
    for i in range(5):
        g = _grads(jp, r, 10.0 ** r.uniform(-3, 0), gdt)
        tg = params_from_jax(jax.tree.map(np.asarray, g), tcfg)
        if clip is None:
            jg, scale = g, None
        else:
            jg = jax.tree.map(lambda x: x * jnp.asarray(clip, x.dtype), g)
            scale = torch.tensor(clip, dtype=torch.float32)
        jp, js = upd(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp, grad_scale=scale)
    assert int(ts["step"]) == int(js["step"]) == 5
    want_s = opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg)
    for a, b in zip(tree_leaves(want_s["m"]) + tree_leaves(want_s["v"]),
                    tree_leaves(ts["m"]) + tree_leaves(ts["v"])):
        assert _bits_equal(a, b)
    want_p = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    ulps = 1 if dtype == "bfloat16" else 8
    for a, b in zip(tree_leaves(want_p), tree_leaves(tp)):
        assert _within_steps(a, b, ulps)


@pytest.mark.parametrize("b", [0.9, 0.999])
def test_bias_corrections_match_over_the_parity_tests_steps(b):
    """`1 - b ** t` in fp32, jitted XLA against `torch.pow`: equal for t
    up to 30, the steps the parity tests take. They part later (seen: at
    t = 31 for 0.9; for 0.999 at 21 values of t in 1..1999, the first
    168), a quirk of the two pow functions, not of the port."""
    t = np.arange(1, 2000, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda s: 1 - b ** s.astype(jnp.float32))(t))
    got = (1 - torch.pow(torch.full((), b, dtype=torch.float32),
                         torch.from_numpy(t).float())).numpy()
    apart = t[ref != got]
    assert not len(apart) or apart[0] > 30, apart[:5]


def test_adamw8bit_state_is_2_bytes_a_parameter_and_mirrors_the_tree():
    tcfg, _, tp = _opt_setup("bfloat16")
    st = adamw8bit().init(tp)
    assert isinstance(st["m"]["layers"], list)
    n = sum(p.numel() for p in tree_leaves(tp))
    codes = sum(t.numel() for t in tree_leaves(st["m"]) + tree_leaves(
        st["v"]) if t.dtype == torch.int8)
    assert codes == 2 * n


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compression_matches_the_jitted_reference():
    r = np.random.default_rng(3)
    for shape in ((64, 64), (1000,), (3, 7, 5)):
        g = (r.normal(size=shape) * 1e-3).astype(np.float32)
        e = (r.normal(size=shape) * 1e-5).astype(np.float32)
        jq, js, je = jax.jit(jcompression.error_feedback_update)(g, e)
        q, s, ne = error_feedback_update(torch.from_numpy(g),
                                         torch.from_numpy(e))
        assert torch.equal(q, _t(jq)) and _bits_equal(s, _t(js))
        assert _bits_equal(ne, _t(je))
        jq, js = jax.jit(jcompression.compress_int8)(g)
        q, s = compress_int8(torch.from_numpy(g))
        assert torch.equal(q, _t(jq)) and _bits_equal(s, _t(js))
        assert _bits_equal(decompress_int8(q, s),
                           _t(jax.jit(jcompression.decompress_int8)(jq, js)))


def test_compression_error_feedback():
    """The reference's assertion: the average dequantized stream with
    error feedback converges to the true gradient."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.normal(size=(64, 64)) * 1e-3).astype(
        np.float32))
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    n = 50
    for _ in range(n):
        q, scale, err = error_feedback_update(g, err)
        acc = acc + decompress_int8(q, scale)
    rel = float(torch.linalg.norm(acc / n - g) / torch.linalg.norm(g))
    assert rel < 0.01, rel


def test_compression_roundtrip_bound():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    q, scale = compress_int8(g)
    err = (decompress_int8(q, scale) - g).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-7


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)


@pytest.mark.parametrize("arch,opt_name,accum", [
    ("llama31-8b", "adamw8bit", 1),
    ("llama31-8b", "adamw", 4),
    ("qwen3-30b-a3b", "adamw8bit", 1),
    ("llama4-maverick-400b-a17b", "adamw8bit", 1),
])
def test_train_step_matches_the_reference_f32(arch, opt_name, accum):
    jcfg = jax_reduced(arch, vocab=1024)
    tcfg = reduced(arch, vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    jopt = (jadamw8bit if opt_name == "adamw8bit" else jadamw)(3e-3)
    topt = (adamw8bit if opt_name == "adamw8bit" else adamw)(3e-3)
    js = jopt.init(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg)
    batch = JSyntheticDataLoader(1024, 4, 32, seed=1).batch_at(0)
    jp, js, jst = jax.jit(jbuild_train_step(jcfg, jopt, remat=True,
                                            accum_steps=accum))(jp, js, batch)
    tp, ts, tst = build_train_step(tcfg, topt, remat=True, accum_steps=accum)(
        tp, ts, SyntheticDataLoader(1024, 4, 32, seed=1).batch_at(0))
    for k in ("loss", "grad_norm", "ce"):
        assert _rel(jst[k], tst[k]) < 1e-5, (k, float(jst[k]), float(tst[k]))
    assert abs(float(jst["aux"]) - float(tst["aux"])) <= \
        1e-5 * max(abs(float(jst["aux"])), 1.0)
    if tcfg.moe is not None:
        assert float(tst["aux"]) > 0          # the MoE's balance loss
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(
        tree_leaves(want), tree_leaves(tp))])
    assert float(diff.max()) <= 3e-3 / 3, float(diff.max())
    assert float(diff.mean()) <= 1e-7, float(diff.mean())


def _train(opt, steps=25, accum=1, seed=0):
    """The reference's `_train`: reduced llama31-8b (d_model 128, ff 256,
    2 layers) in bf16 on batches of 8 x 32."""
    cfg = reduced("llama31-8b", d_model=128, ff=256, layers=2)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    st = opt.init(params)
    step = build_train_step(cfg, opt, remat=True, accum_steps=accum)
    dl = SyntheticDataLoader(cfg.vocab_size, 8, 32, seed=1)
    losses = []
    for i in range(steps):
        params, st, stats = step(params, st, dl.batch_at(i))
        losses.append(float(stats["loss"]))
    return losses


def test_adamw_learns_and_8bit_tracks_fp32():
    """The reference's `test_adamw_learns` and
    `test_adamw8bit_matches_fp32_closely` on the port."""
    l32 = _train(adamw(3e-3))
    assert l32[-1] < l32[0] - 0.5
    l8 = _train(adamw8bit(3e-3))
    assert l8[-1] < l8[0] - 0.5
    assert abs(l8[-1] - l32[-1]) < 0.3


def test_grad_accumulation_equivalence():
    """The reference's: accum_steps=4 over batch 8 ~= accum_steps=1."""
    l1 = _train(adamw(1e-3), steps=8, accum=1)
    l4 = _train(adamw(1e-3), steps=8, accum=4)
    assert abs(l1[-1] - l4[-1]) < 0.15, (l1[-1], l4[-1])


def test_unclipped_step_differs_from_clipped():
    """grad_clip=None takes the gradients as they are."""
    cfg = reduced("llama31-8b")
    p0 = init_params(cfg, device="cpu", generator=torch.Generator()
                     .manual_seed(0), dtype=torch.float32)
    batch = SyntheticDataLoader(cfg.vocab_size, 4, 16).batch_at(0)
    out = []
    for clip in (1e-3, None):
        params = tree_map(torch.clone, p0)
        opt = adamw(3e-3)
        st = opt.init(params)
        params, st, stats = build_train_step(cfg, opt, grad_clip=clip)(
            params, st, batch)
        out.append(st["m"]["embed"].clone())
    assert float(out[0].abs().max()) < float(out[1].abs().max())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.tensor([1, -2, 3], dtype=torch.int8),
                  torch.tensor([1.5, -2.25], dtype=torch.bfloat16)],
            "c": None,
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_bits_equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_save_restore_keep_k(tmp_path, async_save):
    cm = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    for step in (1, 2, 3):
        cm.save(step, _tree(), extra={"step": step})
    cm.wait()
    assert cm.all_steps() == [2, 3]
    tree, extra = cm.restore(3, _tree())
    assert _equal_trees(tree, _tree()) and tree["c"] is None
    assert extra == {"step": 3}


class _DeferredThread:
    """A writer thread that runs only when joined, so the test can change
    the tree between `save` returning and the bytes being written."""

    def __init__(self, target, daemon=None):
        self.target = target

    def start(self):
        pass

    def join(self):
        self.target()


def test_checkpoint_async_save_snapshots_the_tree(tmp_path, monkeypatch):
    """The optimizer writes parameters and state in place: an async save
    must write the values at `save`, not those of a later step."""
    monkeypatch.setattr(ckpt_mod.threading, "Thread", _DeferredThread)
    cm = CheckpointManager(tmp_path, async_save=True)
    live = _tree()
    cm.save(1, live)
    live["a"].add_(100.0)
    live["b"][0].mul_(-1)
    live["b"][1].copy_(torch.tensor([9.0, 9.0]))
    live["step"].fill_(8)
    cm.wait()
    tree, _ = cm.restore(1, _tree())
    assert _equal_trees(tree, _tree())
    assert cm.restore_latest(_tree())[0] == 1


def test_checkpoint_restore_latest_skips_a_corrupt_step(tmp_path):
    cm = CheckpointManager(tmp_path, keep=5, async_save=False)
    cm.save(1, _tree())
    bad = _tree()
    bad["a"] = bad["a"] + 1
    cm.save(2, bad)
    m = json.loads((tmp_path / "step_000000002" / "manifest.json")
                   .read_text())
    m["sha256"] = "0" * 64
    (tmp_path / "step_000000002" / "manifest.json").write_text(
        json.dumps(m))
    step, tree, _ = cm.restore_latest(_tree())
    assert step == 1 and _equal_trees(tree, _tree())
    assert CheckpointManager(tmp_path / "empty").restore_latest(
        _tree()) is None


def test_checkpoint_files_cross_between_the_packages(tmp_path):
    """A flat tree of bf16, fp32, int8 and None written by the reference
    restores bit for bit in the port and the port's in the reference,
    with equal manifests."""
    jtree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "b": [jnp.asarray([1, -2, 3], jnp.int8),
                   jnp.asarray([1.5, -2.25], jnp.bfloat16)],
             "c": None, "step": jnp.asarray(7, jnp.int32)}
    JCheckpointManager(tmp_path / "ref", async_save=False).save(
        4, jtree, extra={"k": 1})
    CheckpointManager(tmp_path / "port", async_save=False).save(
        4, _tree(), extra={"k": 1})
    manifests = [json.loads((tmp_path / d / "step_000000004" /
                             "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    got, extra = CheckpointManager(tmp_path / "ref").restore(4, _tree())
    assert _equal_trees(got, _tree()) and extra == {"k": 1}
    back, _ = JCheckpointManager(tmp_path / "port").restore(4, jtree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype and np.asarray(x).tobytes() == \
            np.asarray(y).tobytes()


def test_checkpoint_restart_continues_training():
    """The reference's: resume from step k reproduces the run."""
    cfg = reduced("llama31-8b", d_model=64, ff=128, layers=2)
    opt = adamw(1e-3)
    dl = SyntheticDataLoader(cfg.vocab_size, 4, 16, seed=2)
    step = build_train_step(cfg, opt, remat=False)

    def run(params, st_, lo, hi):
        for i in range(lo, hi):
            params, st_, stats = step(params, st_, dl.batch_at(i))
        return params, st_, float(stats["loss"])

    def fresh():
        p = init_params(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        return p, opt.init(p)

    _, _, loss_a = run(*fresh(), 0, 10)
    p_b, s_b, _ = run(*fresh(), 0, 5)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, async_save=False)
        cm.save(5, {"params": p_b, "opt": s_b})
        tmpl = fresh()
        stepn, tree, _ = cm.restore_latest({"params": tmpl[0],
                                            "opt": tmpl[1]})
        assert stepn == 5
        _, _, loss_c = run(tree["params"], tree["opt"], 5, 10)
    assert abs(loss_a - loss_c) < 1e-2, (loss_a, loss_c)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

ARGS = ["--reduced", "--layers", "2", "--d-model", "64", "--ff", "128",
        "--vocab", "256", "--batch", "2", "--seq", "16", "--log-every", "1",
        "--opt", "adamw8bit", "--device", "cpu"]


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _, _, history = train_cli.main(ARGS + ck + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     3 loss" in out and "done: 3 steps" in out
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["s"] > 0 for h in history)
    assert f"loss {history[-1]['loss']:8.4f}" in out
    assert CheckpointManager(tmp_path).all_steps() == [2, 3]
    train_cli.main(ARGS + ck + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done: 1 steps" in out
    assert "step     4 loss" in out


def test_launch_train_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1", "--device", "cuda"])


def test_train_small_example_runs(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_small", ROOT / "examples" / "torch_train_small.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--steps", "1", "--batch", "1", "--seq", "8", "--device",
              "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "10L d=640 ff=2560 vocab=16384" in out and "done: 1 steps" in out
    assert CheckpointManager(tmp_path).all_steps() == [1]
    assert os.path.isfile(tmp_path / "step_000000001" / "arrays.npz")
