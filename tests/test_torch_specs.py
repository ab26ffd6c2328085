"""The port's dry-run specs (`repro_torch.launch.specs`) against the
reference's (`repro.launch.specs`), on the CPU.

Both run on abstract meshes (`jax.sharding.AbstractMesh` and the port's
`AbstractMesh`, no devices) of the production shapes (16, 16) and (2, 16,
16), for every registered config at full size: the reference's abstract
parameters from `eval_shape`, the port's on the `meta` device. Specs are
equal element for element, with the trees mapped as
`tests/test_torch_parallel.py` maps `param_spec_tree`: the port keeps one
dict a layer, so its layer specs are the reference's without the stacked
(scan) dimension. Where ZeRO-1 or FSDP puts the reference's data axis on
that stacked dimension, the port's layer has none; its spec is then the
reference's own `zero1_spec` of the unstacked leaf (the next free
dimension), so a device holds the same bytes.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.launch.specs as jspecs
from repro.configs import SHAPES_BY_NAME as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.parallel import sharding as jsharding
import repro_torch.launch.specs as tspecs
from repro_torch.configs import ALL_ARCHS, SHAPES_BY_NAME, get_config
from repro_torch.models import model as tmodel
from repro_torch.models.model import unit_size
from repro_torch.parallel.sharding import AbstractMesh, P

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _spec(x):
    return tuple(x.spec if hasattr(x, "spec") else x)


def _is_leaf(x):
    return hasattr(x, "spec") or isinstance(x, jax.sharding.PartitionSpec)


def _want(ref, ref_tp, shape, jmesh, stacked):
    """The port's expected spec for a reference leaf's spec `ref` (its TP
    spec `ref_tp`, its stacked shape `shape`)."""
    ref = _spec(ref)
    if not stacked:
        return ref
    if not ref or ref[0] is None:
        return ref[1:]
    # the data axis sits on the stacked dim: the next free one instead
    unstacked = jax.sharding.PartitionSpec(*_spec(ref_tp)[1:])
    return tuple(jsharding.zero1_spec(unstacked, shape[1:], jmesh))


def _compare(ref, ref_tp, ref_abs, port, jmesh, unit, stacked=False,
             where=""):
    if isinstance(ref, dict):
        keys = set(ref)
        pkeys = set(port)
        if "blocks" in keys:
            assert keys - {"blocks"} == pkeys - {"layers"}, where
        else:
            assert keys == pkeys, where
        for k in ref:
            if k == "blocks":
                for i, layer in enumerate(port["layers"]):
                    _compare(ref[k][i % unit], ref_tp[k][i % unit],
                             ref_abs[k][i % unit], layer, jmesh, unit, True,
                             f"{where}/layers/{i}")
            elif k == "encoder":
                for i, layer in enumerate(port["encoder"]):
                    _compare(ref[k], ref_tp[k], ref_abs[k], layer, jmesh,
                             unit, True, f"{where}/encoder/{i}")
            else:
                _compare(ref[k], ref_tp[k], ref_abs[k], port[k], jmesh,
                         unit, stacked, f"{where}/{k}")
        return
    if isinstance(ref, (list, tuple)) and not _is_leaf(ref):
        assert len(ref) == len(port), where
        for i, (r, t, a, q) in enumerate(zip(ref, ref_tp, ref_abs, port)):
            _compare(r, t, a, q, jmesh, unit, stacked, f"{where}/{i}")
        return
    if ref is None:
        assert port is None, where
        return
    want = _want(ref, ref_tp, ref_abs.shape, jmesh, stacked)
    assert isinstance(port, P) and tuple(port) == want, (where, ref, port)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(the reference's abstract parameters, the port's meta ones)."""
    return (jspecs.abstract_params(jget_config(arch)),
            tspecs.abstract_params(get_config(arch)))


def _meshes(name):
    shape, names = MESHES[name]
    return JAbstractMesh(shape, names), AbstractMesh(shape, names)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", ["on", "off", "auto"])
def test_param_shardings_equal_the_references(mesh_name, fsdp):
    jmesh, tmesh = _meshes(mesh_name)
    for arch in ALL_ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        jp, tp = _params(arch)
        ref = jspecs.param_shardings(jcfg, jp, jmesh, fsdp=fsdp)
        ref_tp = jsharding.param_spec_tree(
            jp, jmesh, tied_embeddings=jcfg.tie_embeddings)
        port = tspecs.param_shardings(tcfg, tp, tmesh, fsdp=fsdp)
        _compare(ref, ref_tp, jp, port, jmesh, unit_size(tcfg),
                 where=f"{arch} {mesh_name} fsdp={fsdp}")


def test_fsdp_auto_switches_where_the_reference_does():
    """llama4-maverick's TP-only weights exceed the 4e9-byte budget on both
    meshes, llama31-8b's do not: "auto" turns FSDP on for the first only,
    as the reference's rule does."""
    jmesh, tmesh = _meshes("16x16")
    for arch, on in (("llama4-maverick-400b-a17b", True),
                     ("llama31-8b", False)):
        tcfg = get_config(arch)
        tp = _params(arch)[1]
        auto = tspecs.param_shardings(tcfg, tp, tmesh)
        forced = tspecs.param_shardings(tcfg, tp, tmesh,
                                        fsdp="on" if on else "off")
        assert auto == forced, arch


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_opt_shardings_equal_the_references(mesh_name):
    from repro.training import adamw8bit as jadamw8bit
    from repro_torch.training import adamw8bit
    jmesh, tmesh = _meshes(mesh_name)
    for arch in ALL_ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        jp, tp = _params(arch)
        jopt = jax.eval_shape(jadamw8bit(1e-3).init, jp)
        topt = adamw8bit(1e-3).init(tp)
        ref = jspecs.opt_shardings(jcfg, jopt, jmesh)
        ref_tp = jsharding.param_spec_tree(
            jopt, jmesh, tied_embeddings=jcfg.tie_embeddings)
        port = tspecs.opt_shardings(tcfg, topt, tmesh)
        _compare(ref, ref_tp, jopt, port, jmesh, unit_size(tcfg),
                 where=f"{arch} {mesh_name}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_batch_and_input_specs_equal_the_references(mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    for arch in ALL_ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        U = unit_size(tcfg)
        for shape in tcfg.shapes():
            jshape = JSHAPES[shape.name]
            jin = jspecs.input_specs(jcfg, jshape)
            tin = tspecs.input_specs(tcfg, shape)
            assert set(jin) == set(tin), (arch, shape.name)
            for k in jin:
                assert tuple(jin[k].shape) == tuple(tin[k].shape)
                assert str(jin[k].dtype) == str(tin[k].dtype).replace(
                    "torch.", ""), (arch, shape.name, k)
                assert tin[k].device.type == "meta"
            jb = jspecs.batch_shardings(jin, jmesh)
            tb = tspecs.batch_shardings(tin, tmesh)
            assert {k: _spec(v) for k, v in jb.items()} == \
                {k: tuple(v) for k, v in tb.items()}, (arch, shape.name)
            if shape.kind != "decode":
                continue
            B = shape.global_batch
            enc = jcfg.frontend_len or 1500 if jcfg.encoder_layers else 0
            jc = jmodel.abstract_cache(jcfg, B, shape.seq_len, enc)
            tc = tmodel.abstract_cache(tcfg, B, shape.seq_len, enc)
            jcs = jspecs.cache_shardings(jcfg, jc, jmesh)
            tcs = tspecs.cache_shardings(tcfg, tc, tmesh)
            where = f"{arch} {shape.name} {mesh_name}"
            assert _spec(jcs["len"]) == tuple(tcs["len"]), where
            assert len(tcs["layers"]) == tcfg.num_layers, where
            for i, layer in enumerate(tcs["layers"]):
                ref = jcs["blocks"][i % U]
                assert set(ref) == set(layer), where
                for name in ref:
                    assert _spec(ref[name])[1:] == tuple(layer[name]), \
                        (where, i, name, ref[name], layer[name])
                    assert tuple(jc["blocks"][i % U][name].shape[1:]) == \
                        tuple(tc["layers"][i][name].shape), (where, name)


def test_build_cell_returns_the_references_parts():
    """Each kind's builder: the arguments' shapes, the specs' structure,
    the donated arguments and the train cell's micro-batching rule (16
    micro-batches past 1e11 parameters, else 8)."""
    jmesh, tmesh = _meshes("16x16")
    cfg = get_config("whisper-base")
    for shape_name, n_args, donate in (("train_4k", 3, (0, 1)),
                                       ("prefill_32k", 2, ()),
                                       ("decode_32k", 3, (2,))):
        fn, args, specs, don = tspecs.build_cell(
            cfg, SHAPES_BY_NAME[shape_name], tmesh)
        jfn, jargs, jsh, jdon = jspecs.build_cell(
            jget_config("whisper-base"), JSHAPES[shape_name], jmesh)
        assert callable(fn) and len(args) == len(specs) == n_args
        assert don == tuple(jdon) == donate
    calls = {}

    def fake_step(cfg, opt, qcfg=None, remat=True, accum_steps=1):
        calls[cfg.name] = accum_steps
        return None

    import repro_torch.training as training
    orig = training.build_train_step
    training.build_train_step = fake_step
    try:
        for arch, want in (("llama4-maverick-400b-a17b", 16),
                           ("whisper-base", 8)):
            c = get_config(arch)
            tspecs.build_train_cell(c, SHAPES_BY_NAME["train_4k"], tmesh)
            assert calls[arch] == want
    finally:
        training.build_train_step = orig


def test_placements_tree_maps_every_spec():
    from torch.distributed.tensor import Replicate, Shard
    _, tmesh = _meshes("2x16x16")
    tree = {"a": P(("pod", "data"), "model"), "b": [P(), None],
            "c": {"q": P(None, "model"), "scale": P()}}
    pl = tspecs.placements_tree(tree, tmesh)
    assert pl["a"] == (Shard(0), Shard(0), Shard(1))
    assert pl["b"] == [(Replicate(),) * 3, None]
    assert pl["c"]["q"] == (Replicate(), Replicate(), Shard(1))
