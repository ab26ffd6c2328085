"""The port's `parallel/` and the mesh half of `models/model.py` against
the reference's `repro.parallel` and `repro.models.model`, on the CPU.

In process: the sharding rules. `jax.sharding.AbstractMesh` needs no
devices, so the reference's `param_spec_tree` runs on the production
meshes here; the port's runs on its own `AbstractMesh` over its parameters
as meta tensors (int8 matrices stored K-major, read by their logical
shape). Specs are equal element for element; the port keeps one dict a
layer, so its layer specs are the reference's without the stacked (scan)
dimension.

Across ranks, once per module: the reference in a subprocess on 4 forced
host devices (as `tests/test_parallel.py` runs it), the port in 4 `gloo`
processes that rendezvous through a file (`tests/torch_parallel_ranks.py`;
no network), both on the same numpy-drawn inputs and the reference's
parameters. Tolerances: the flash-decoding combine 2e-4 (the reference's
own test's), the pipeline 2e-5 (likewise), the ring all-gather exact, the
sharded f32 decode step 1e-5 of the logits' largest magnitude and K/V
one bf16 step (the cache is bf16 on both sides).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.parallel import sharding as jsharding
from repro.quant import quantize_tree as jquantize_tree
from repro_torch.configs import _REGISTRY, get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.models.model import unit_size
from repro_torch.parallel import sharding as tsharding
from repro_torch.parallel.collectives import (combine_partial_softmax,
                                              ring_all_gather)
from repro_torch.parallel.sharding import (P, AbstractMesh, logical_spec,
                                           param_spec_tree, shardings_for,
                                           zero1_spec)

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single pod": ((16, 16), ("data", "model")),
          "two pods": ((2, 16, 16), ("pod", "data", "model"))}


def _unstacked(spec):
    """A reference spec of a stacked (scan) leaf without its leading dim."""
    return tuple(spec)[1:]


def _same_specs(ref, port, stacked=False, where=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), where
        for k in ref:
            _same_specs(ref[k], port[k], stacked, f"{where}/{k}")
        return
    if ref is None:
        assert port is None, where
        return
    want = _unstacked(ref) if stacked else tuple(ref)
    assert isinstance(port, P) and tuple(port) == want, (where, ref, port)


def _jax_abstract_params(cfg, quant):
    def build():
        p = jinit_params(jax.random.PRNGKey(0), cfg)
        return jquantize_tree(p, quant) if quant != "bf16" else p
    return jax.eval_shape(build)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_param_spec_tree_equals_the_references_for_every_config(quant):
    """Every config the port registers, at full size, on both production
    meshes (16, 16) and (2, 16, 16): the port's specs of its meta-tensor
    parameters equal the reference's of its abstract ones."""
    for name in sorted(_REGISTRY):
        jcfg, tcfg = jget_config(name), get_config(name)
        jp = _jax_abstract_params(jcfg, quant)
        tp = init_params(tcfg, device="meta", generator=torch.Generator(),
                         quant=quant)
        U = unit_size(tcfg)
        for shape, names in MESHES.values():
            jspecs = jsharding.param_spec_tree(
                jp, JAbstractMesh(shape, names),
                tied_embeddings=jcfg.tie_embeddings)
            tspecs = param_spec_tree(tp, AbstractMesh(shape, names),
                                     tied_embeddings=tcfg.tie_embeddings)
            where = f"{name} {quant} {shape}"
            assert set(jspecs) - {"blocks"} == set(tspecs) - {"layers"}, \
                where
            for k in jspecs:
                if k == "blocks":
                    for i, layer in enumerate(tspecs["layers"]):
                        _same_specs(jspecs["blocks"][i % U], layer, True,
                                    f"{where}/layers/{i}")
                elif k == "encoder":
                    for i, layer in enumerate(tspecs["encoder"]):
                        _same_specs(jspecs["encoder"], layer, True,
                                    f"{where}/encoder/{i}")
                else:
                    _same_specs(jspecs[k], tspecs[k], False, f"{where}/{k}")


def test_param_specs_of_llama4_maverick_shard_its_experts():
    """The experts (128) over the model axis, the vocabulary of the
    lm_head too; the int8 lm_head read by its (K, N) shape, though it is
    stored K-major."""
    mesh = make_production_mesh()
    tp = init_params(get_config("llama4-maverick-400b-a17b"), device="meta",
                     generator=torch.Generator(), quant="int8")
    assert tp["lm_head"]["q"].stride() == (1, 5120)
    specs = param_spec_tree(tp, mesh)
    assert specs["lm_head"]["q"] == P(None, "model")
    assert specs["layers"][1]["moe"]["experts_up"]["q"] == P("model")
    assert specs["layers"][1]["moe"]["shared"]["down"]["q"] == P("model")
    assert specs["layers"][0]["mlp"]["gate"]["q"] == P(None, "model")


def _jmesh(shape, names):
    return JAbstractMesh(shape, names)


@pytest.mark.parametrize("shape,names", [((2, 4), ("data", "model")),
                                         ((16, 16), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data",
                                                        "model"))])
def test_logical_and_zero1_specs_on_the_references_cases(shape, names):
    """The reference's own cases (`tests/test_parallel.py`) and more, on
    each mesh: the drop-if-not-divisible rule, the use-each-mesh-axis-once
    rule, the batch over (pod, data), ZeRO-1 on the first free divisible
    dim."""
    jm, tm = _jmesh(shape, names), AbstractMesh(shape, names)
    cases = [((8, 16), (None, "ff")), ((8, 6), (None, "qheads")),
             ((8, 4), ("batch", None)), ((4, 16, 16), ("batch", "ff",
                                                       "vocab")),
             ((64, 1, 32, 256, 128), ("batch", "kvheads", "kv_seq_tp",
                                      None)),
             ((1, 8, 1024, 128), ("batch", "kvheads", "kv_seq_tp", None)),
             ((32, 512, 4096), ("batch", "seq", "d_model"))]
    for s, n in cases:
        want = jsharding.logical_spec(s, n, jm)
        assert tuple(logical_spec(s, n, tm)) == tuple(want), (s, n)
        for z_shape in (s, tuple(reversed(s))):
            assert tuple(zero1_spec(logical_spec(s, n, tm), z_shape, tm)) \
                == tuple(jsharding.zero1_spec(want, z_shape, jm)), (s, n)
    rules = jsharding.DEFAULT.but(seq="model")
    assert tuple(logical_spec((4, 32, 8), ("batch", "seq", None), tm,
                              tsharding.DEFAULT.but(seq="model"))) == tuple(
        jsharding.logical_spec((4, 32, 8), ("batch", "seq", None), jm,
                               rules))


def test_the_references_spec_cases_and_no_mesh():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    assert logical_spec((8, 16), (None, "ff"), mesh) == P(None, "model")
    assert logical_spec((8, 6), (None, "qheads"), mesh) == P()
    assert logical_spec((8, 4), ("batch", None), mesh) == P("data")
    assert logical_spec((4, 16, 16), ("batch", "ff", "vocab"), mesh) == \
        P("data", "model")
    assert zero1_spec(P(None, "model"), (8, 16), mesh) == P("data", "model")
    # no mesh: everything replicated
    assert logical_spec((4, 8), ("batch", "ff")) == P()
    assert zero1_spec(P(), (4, 8)) == P()
    assert param_spec_tree({"embed": torch.zeros(4, 2)}) == {"embed": P()}
    # the reference's PartitionSpec keeps trailing Nones, and so does P
    assert tuple(jax.sharding.PartitionSpec("a", None)) == \
        tuple(P("a", None)) != tuple(P("a"))


def test_shardings_for_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 4), ("data", "model"))
    pl = shardings_for({"lm_head": torch.empty(8, 16, device="meta"),
                        "embed": torch.empty(16, 8, device="meta")}, mesh)
    assert pl["lm_head"] == (Replicate(), Shard(1))
    assert pl["embed"] == (Replicate(), Replicate())
    tied = shardings_for({"embed": torch.empty(16, 8, device="meta")}, mesh,
                         tied_embeddings=True)
    assert tied["embed"] == (Replicate(), Shard(0))
    both = tsharding.placements(P(("data", "model")), mesh)
    assert both == (Shard(0), Shard(0))


def test_meshes_and_collectives_without_a_group():
    """The production meshes are abstract; the host mesh without a process
    group is the one-device (1, 1); a collective raises without a group."""
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    host = make_host_mesh(model=2)
    assert host.shape == {"data": 1, "model": 1}
    x = torch.zeros(2, 1, 4, 1)
    with pytest.raises(RuntimeError, match="process group"):
        combine_partial_softmax(x, x, x)
    with pytest.raises(RuntimeError, match="process group"):
        ring_all_gather(x)


# ---------------------------------------------------------------------------
# Across ranks
# ---------------------------------------------------------------------------

_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import reduced
from repro.models import attention as attn, decode_step, init_params, prefill
from repro.models import model as jmodel
from repro.parallel import collectives
from repro.parallel.collectives import combine_partial_softmax
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.sharding import shardctx

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}

def combine(n):
    mesh = jax.make_mesh((n,), ("kv",))
    c = inp["combine"]
    def shard_fn(q, kc, vc, cache_len):
        i = jax.lax.axis_index("kv")
        s_loc = kc.shape[2]
        pos = i * s_loc + jnp.arange(s_loc)
        valid = pos[None, :] < cache_len[:, None]
        num, den, m = attn.decode_attention_partial(q, kc, vc, valid)
        return combine_partial_softmax(num, den, m, "kv")
    f = shard_map(shard_fn, mesh=mesh,
                  in_specs=(P(), P(None, None, "kv"), P(None, None, "kv"),
                            P()), out_specs=P(), check_rep=False)
    return np.asarray(f(*(jnp.asarray(c[k]) for k in
                          ("q", "kc", "vc", "cache_len"))))

out["combine"] = {n: combine(n) for n in (2, 4)}
pp = inp["pipeline"]
out["pipeline"] = np.asarray(pipeline_apply(
    lambda p, x: jnp.tanh(x @ p["w"]), {"w": jnp.asarray(pp["w"])},
    jnp.asarray(pp["x"]), jax.make_mesh((4,), ("stage",))))

calls = [0]
inner = collectives.combine_partial_softmax
def counted(*a, **k):
    calls[0] += 1
    return inner(*a, **k)
collectives.combine_partial_softmax = counted
# the reference's host mesh, (2, 2), with Auto axes: `jax.make_mesh` (its
# `make_host_mesh`) makes Explicit ones under JAX 0.9, on which
# `with_sharding_constraint` refuses any spec that names an axis
AUTO = jax.sharding.AxisType.Auto
host = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AUTO, AUTO))
meshes = {"data4": jax.make_mesh((4,), ("data",), axis_types=(AUTO,)),
          "mesh22": host}
out["gates"] = {}
for name, case in inp["gates"].items():
    before = calls[0]
    with shardctx(meshes[case["mesh"]]):
        o = jmodel._flash_decode_attention(
            *(jnp.asarray(case[k]) for k in ("q", "kc", "vc", "cache_len")))
    out["gates"][name] = {"sharded": calls[0] > before,
                          "out": np.asarray(o)}

cfg = reduced("llama31-8b", vocab=1024)
params = init_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
tokens = jnp.asarray(inp["decode_tokens"])
logits, cache = prefill(params, cfg, {"tokens": tokens},
                        max_len=tokens.shape[1] + 4)
token = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
out["params"] = jax.tree.map(np.asarray, params)
out["cache"] = jax.tree.map(np.asarray, cache)
out["token"] = np.asarray(token)
jmodel.PERF.flash_decode = True
before = calls[0]
logits = []
with shardctx(host):
    for _ in range(2):
        lg, cache = decode_step(params, cfg, token, cache)
        logits.append(np.asarray(lg))
        token = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
out["decode"] = {
    "logits": logits, "sharded_calls": calls[0] - before,
    "k": [np.asarray(b["k"], np.float32) for b in cache["blocks"]],
    "v": [np.asarray(b["v"], np.float32) for b in cache["blocks"]]}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _gate_case(rng, mesh, B, Hq, Hkv, S, D=8):
    return {"mesh": mesh,
            "q": rng.normal(size=(B, 1, Hq, D)).astype(np.float32),
            "kc": rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
            "vc": rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
            "cache_len": rng.integers(1, S + 1, B).astype(np.int32)}


def _inputs():
    rng = np.random.default_rng(0)
    B, Hq, Hkv, S, D = 2, 8, 2, 64, 32
    combine = {"q": rng.normal(size=(B, 1, Hq, D)).astype(np.float32),
               "kc": rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
               "vc": rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
               "cache_len": np.array([37, 64], np.int32)}
    St, NM, MB, Dp = 4, 8, 2, 16
    pipeline = {"w": (rng.normal(size=(St, Dp, Dp)) * 0.3).astype(
        np.float32),
                "x": rng.normal(size=(NM, MB, Dp)).astype(np.float32)}
    gates = {
        "past every gate": _gate_case(rng, "mesh22", 2, 4, 1, 16),
        "no model axis": _gate_case(rng, "data4", 4, 4, 1, 16),
        "S not divisible by model": _gate_case(rng, "mesh22", 2, 4, 1, 15),
        "KV heads fill the model axis": _gate_case(rng, "mesh22", 2, 4, 2,
                                                   16),
        "batch under the data degree": _gate_case(rng, "mesh22", 1, 4, 1,
                                                  16),
    }
    return {"combine": combine, "pipeline": pipeline, "gates": gates,
            "ring": rng.normal(size=(6, 8)).astype(np.float32),
            "mamba_x": rng.normal(size=(4, 8, 64)).astype(np.float32),
            "decode_tokens": rng.integers(0, 1000, (2, 12)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results, the port's results on 4 ranks)."""
    d = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    paths = {k: str(d / f"{k}.pkl") for k in ("inputs", "ref", "port")}
    with open(paths["inputs"], "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        paths["inputs"], paths["ref"]], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(REPO / "tests" /
                                            "torch_parallel_ranks.py"),
                        paths["inputs"], paths["ref"], paths["port"]],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(paths["ref"], "rb") as f:
        ref = pickle.load(f)
    with open(paths["port"], "rb") as f:
        port = pickle.load(f)
    return inp, ref, port


@pytest.mark.parametrize("n", [2, 4])
def test_combine_partial_softmax_on_ranks_matches_the_reference(runs, n):
    """B 2, Hq 8, Hkv 2, S 64, D 32, cache_len [37, 64], split over n
    sequence shards: within 2e-4 of the reference's shard_map."""
    _, ref, port = runs
    np.testing.assert_allclose(port["combine"][n], ref["combine"][n],
                               rtol=2e-4, atol=2e-4)


def test_ring_all_gather_equals_all_gather(runs):
    assert runs[2]["ring_equal"]


def test_pipeline_apply_on_ranks_matches_the_reference(runs):
    """4 stages, 8 microbatches of 2 x 16, tanh stages: within 2e-5 of the
    reference's pipeline, the same on every rank, and of the stages run in
    sequence."""
    inp, ref, port = runs
    np.testing.assert_allclose(port["pipeline"], ref["pipeline"],
                               rtol=2e-5, atol=2e-5)
    assert port["pipeline_same_on_every_rank"]
    want = inp["pipeline"]["x"]
    for w in inp["pipeline"]["w"]:
        want = np.tanh(want @ w)
    np.testing.assert_allclose(port["pipeline"], want, rtol=2e-5, atol=2e-5)


def test_host_mesh_is_data_by_model(runs):
    assert runs[2]["host_mesh"] == (("data", "model"), (2, 2))


@pytest.mark.parametrize("case", ["past every gate", "no model axis",
                                  "S not divisible by model",
                                  "KV heads fill the model axis",
                                  "batch under the data degree"])
def test_flash_decode_gates_fall_back_where_the_references_do(runs, case):
    """Each of the reference's four gates sends the port to the plain
    `decode_attention` too (no combine); past them both combine, and the
    results agree within 2e-4; every rank returns the same."""
    _, ref, port = runs
    r, p = ref["gates"][case], port["gates"][case]
    assert p["sharded"] == r["sharded"] == (case == "past every gate")
    assert p["same_on_every_rank"]
    np.testing.assert_allclose(p["out"], r["out"], rtol=2e-4, atol=2e-4)
    if not p["sharded"]:
        np.testing.assert_array_equal(p["out"], p["plain"])


def test_sharded_decode_step_matches_the_reference(runs):
    """Reduced llama31-8b (one KV head, so past every gate on (2, 2)), f32
    parameters, two decode steps under `shardctx` with
    `PERF.flash_decode`, from the reference's prefilled cache: logits
    within 1e-5 of their largest magnitude, K/V within one bf16 step,
    every attention layer through the combine on both sides (the
    reference traces its scanned layer once a step)."""
    _, ref, port = runs
    r, p = ref["decode"], port["decode"]
    assert p["sharded_calls"] == 2 * 2 and r["sharded_calls"] == 2
    for a, b in zip(r["logits"], p["logits"]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    for n in ("k", "v"):
        for i, layer in enumerate(p[n]):      # one unit position, stacked
            np.testing.assert_allclose(layer, r[n][0][i], atol=2 ** -7,
                                       rtol=0)
    assert p["same_on_every_rank"]


def test_local_batch_shard_map_on_ranks(runs):
    """A Mamba block on each rank's batch shard, gathered, equals the
    block on the whole batch; at batch 1 (under the data degree) it is
    the block itself."""
    lb = runs[2]["local_batch"]
    assert lb["shapes_equal"] and lb["max_diff"] <= 1e-6, lb
    assert lb["fallback_equal"]


def test_constrain_redistributes_a_dtensor_only(runs):
    assert runs[2]["constrain"] == {"placements": True, "values": True,
                                    "plain": True}


def test_dtensor_decode_steps_equal_the_plain_ones(runs):
    """Reduced llama31-8b's parameters, cache and token as DTensors at
    `launch.specs`' placements on the (2, 2) mesh, as the dry-run runs a
    cell: two decode steps equal the plain ones (f32; logits within 1e-5
    of their largest, the bf16 cache within one bf16 step), without and
    with `PERF.flash_decode`, and the logits stay DTensors; likewise
    reduced codeqwen1.5-7b, whose 4 KV heads split over the model axis."""
    dt = runs[2]["dtensor"]
    for case in ("decode flash=False", "decode flash=True",
                 "decode codeqwen"):
        d = dt[case]
        assert d["dtensor"], case
        assert d["logits"] <= 1e-5, (case, d)
        assert d["kv"] <= 2 ** -8, (case, d)


def test_dtensor_train_step_equals_the_plain_one(runs):
    """One adamw8bit train step of 2 micro-batches with DTensor
    parameters, state and batch on the (2, 2) mesh: the loss and the
    gradient norm within 1e-5 of the plain step's (fp32 sums in another
    order), the updated parameters within 1e-3 of their largest
    magnitude (a moment whose fp32 value sits at an 8-bit code boundary
    may take the next code) and at least 99% of the m codes equal."""
    t = runs[2]["dtensor"]["train"]
    assert t["step"]
    assert t["loss"] <= 1e-5 and t["grad_norm"] <= 1e-5, t
    assert t["params"] <= 1e-3, t
    assert t["m_codes_equal_share"] >= 0.99, t


@pytest.fixture(scope="module")
def restores(tmp_path_factory):
    """The sharded restore on 2 and on 4 gloo ranks."""
    out = {}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"restore{world}")
        procs[world] = (d / "out.pkl", subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_parallel_ranks.py"),
             "--restore", str(world), str(d / "out.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for world, (path, proc) in procs.items():
        o, e = proc.communicate(timeout=300)
        assert proc.returncode == 0, o + e
        with open(path, "rb") as f:
            out[world] = pickle.load(f)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_restore_places_each_ranks_shard(restores, world):
    """Rank 0 saves reduced llama31-8b's bf16 parameters and adamw8bit
    state; every rank restores them with `shardings` (FSDP parameters and
    ZeRO-1 state, on (2, 1) or (2, 2)): every leaf a DTensor whose local
    shard is, bit for bit (bf16 through uint16), this rank's slice of the
    unsharded restore; some of them really split. The newest step,
    corrupted, is skipped by `restore_latest`, which returns step 1 placed
    the same way."""
    for rank, f in enumerate(restores[world]):
        assert f["equal"], (world, rank, f)
        assert f["dtensors"] == f["leaves"] > 0, (world, rank, f)
        assert f["sharded"] > 0, (world, rank, f)
        assert f["extra"] and f["latest_step"] == 1 and f["latest_equal"]
