"""The port's dry-run (`repro_torch.launch.dryrun`) on fake process
groups, against the reference's (`repro.launch.dryrun`), on the CPU.

A fake process group is process-wide and stays until destroyed, so the
port's cells run in a subprocess (as `tests/test_dryrun.py` runs the
reference's, whose 512 host devices must be set before JAX starts). A
second subprocess runs the reference's `run_cell` on the same cells,
its production mesh rebuilt with `AxisType.Auto` axes: JAX 0.9's
`jax.make_mesh` gives Explicit axes, on which the reference's first
`with_sharding_constraint` raises. Both run at once, with `hw="tpu-v5e"`.

  (a) the counters, exactly: the (128, 4096) @ (4096, 14336) product on
      (16, 16), x placed (Shard(0), Replicate()), w (Replicate(),
      Shard(1)), is 58,720,256 FLOPs a device (the local product; the
      global 15,032,385,536 is not counted too), and its reshard to
      (Shard(0), Replicate()) one all-gather of the local operand's bytes;
  (b) whisper-base decode_32k on 16x16 and 2x16x16: status ok, 256 and
      512 devices, compute_s, model_flops and memory_analytic_s equal to
      the reference's record, and what the counter measured held against
      that record and the config:
        - argument bytes: the specs' shard bytes; less the arguments no op
          read (the encoder's parameters and the decoder's cross-attention
          K/V projections: decode reads the cross K/V from the cache),
          exactly XLA's, which drops unused arguments;
        - FLOPs a device: within [0.9, 3.5] x the analytic count. Below 1
          by the embedding lookup, a gather (3.2% of llama31-8b's);
          whisper-base's 3.0x is its 51,865-word head, which does not
          divide the model axis and so runs whole on each rank's batch
          shard (1.60x), and its cross-attention over 1,500 frames
          (0.56x), which the analytic decode count leaves out;
        - collective bytes: within [1/8, 1] x XLA's total, all-reduces on
          both sides. The port reduces the row-parallel partial sums in
          bf16 where XLA reduces them in fp32, replicates the heads that
          do not fill the model axis where XLA splits head_dim over 2
          (and then all-reduces P.V and the cross-attention scores), and
          reduces the decode softmax's max and sum over the sequence
          shards as XLA does (two all-reduces of one value a row);
  (d) hillclimb's and optimized_sweep's state: `perf_variant` equals the
      reference's for every config; `run_variant` and `perf_overrides`
      restore `PERF`, the FSDP threshold and `_REGISTRY`, also after an
      exception; a failing cell is a FAIL and exit code 1.
The multi-pod train cell is in `tests/test_torch_dryrun_train.py`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PORT = r"""
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch import dryrun
out = {}
with dryrun.fake_mesh() as mesh:
    fm = FakeTensorMode()
    x = dryrun.shard_like(torch.empty(128, 4096, dtype=torch.bfloat16,
                                      device="meta"),
                          mesh, (Shard(0), Replicate()), fm)
    w = dryrun.shard_like(torch.empty(4096, 14336, dtype=torch.bfloat16,
                                      device="meta"),
                          mesh, (Replicate(), Shard(1)), fm)
    c1, c2 = dryrun.OpCounter(), dryrun.OpCounter()
    with fm, dryrun.counting(c1):
        y = x @ w
    with fm, dryrun.counting(c2):
        z = y.redistribute(mesh, (Shard(0), Replicate()))
    out["matmul"] = {"flops": c1.flops, "coll": c1.collectives,
                     "placements": [str(p) for p in y.placements],
                     "local": list(y.to_local().shape)}
    out["reshard"] = {"flops": c2.flops, "coll": c2.collectives,
                      "operand_bytes": y.to_local().numel() * 2,
                      "local": list(z.to_local().shape)}
    try:
        dryrun.run_cell("whisper-base", "decode_32k", save=False,
                        verbose=False)
        out["refused"] = False
    except RuntimeError as e:
        out["refused"] = "already initialised" in str(e)
out["group_left"] = dist.is_initialized()
out["cells"] = [dryrun.run_cell("whisper-base", "decode_32k", multi_pod=mp,
                                hw="tpu-v5e", save=False, verbose=False)
                for mp in (False, True)]
out["group_left_after_cells"] = dist.is_initialized()
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
out["want"] = []
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    _, args, sp, _ = specs.build_cell(get_config("whisper-base"),
                                      SHAPES_BY_NAME["decode_32k"], mesh)
    p, ps = args[0], sp[0]
    unread = sum(specs.shard_bytes(p[k], ps[k], mesh)
                 for k in ("encoder", "enc_pos_embed", "enc_final_norm"))
    unread += sum(specs.shard_bytes(lp["xattn"][w], ls["xattn"][w], mesh)
                  for lp, ls in zip(p["layers"], ps["layers"])
                  for w in ("wk", "wv"))
    out["want"].append({"arguments": specs.shard_bytes(args, sp, mesh),
                        "unread": unread})
print("JSON" + json.dumps(out))
"""

REF = r"""
import json
import repro.launch.dryrun as d
import jax
from jax.sharding import AxisType
def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
d.make_production_mesh = auto_mesh
recs = [d.run_cell("whisper-base", "decode_32k", multi_pod=mp, hw="tpu-v5e",
                   save=False, verbose=False) for mp in (False, True)]
from repro.configs import ALL_ARCHS, get_config
from repro.launch.optimized_sweep import perf_variant
variants = {}
for arch in ALL_ARCHS:
    v = perf_variant(get_config(arch))
    variants[arch] = [v.flash_decode, v.local_recurrence,
                      jax.numpy.dtype(v.kv_cache_dtype).name]
print("JSON" + json.dumps({"cells": recs, "perf_variant": variants}))
"""


def _spawn(code):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def runs():
    port, ref = _spawn(PORT), _spawn(REF)
    return _result(port), _result(ref)


def test_counters_are_exact_on_the_unit_case(runs):
    port, _ = runs
    mm = port["matmul"]
    assert mm["flops"] == 2 * 8 * 4096 * 896 == 58_720_256
    assert mm["local"] == [8, 896]
    assert mm["placements"] == ["S(0)", "S(1)"]
    assert all(v == 0 for v in mm["coll"].values())
    rs = port["reshard"]
    assert rs["flops"] == 0
    assert rs["coll"]["all-gather"] == rs["operand_bytes"] == 8 * 896 * 2
    assert sum(rs["coll"].values()) == rs["operand_bytes"]
    assert rs["local"] == [8, 14336]


def test_a_second_group_is_refused_and_each_cell_destroys_its_own(runs):
    port, _ = runs
    assert port["refused"] is True
    assert port["group_left"] is False
    assert port["group_left_after_cells"] is False


def test_whisper_decode_on_both_meshes_matches_the_references_roofline(runs):
    port, ref = runs
    for rec, jrec, n in zip(port["cells"], ref["cells"], (256, 512)):
        assert rec["status"] == "ok" and jrec["status"] == "ok"
        assert rec["n_devices"] == jrec["n_devices"] == n
        assert rec["mesh"] == jrec["mesh"]
        t, jt = rec["roofline"], jrec["roofline"]
        assert t["compute_s"] > 0
        for k in ("compute_s", "model_flops", "memory_analytic_s",
                  "flops_per_device"):
            assert t[k] == jt[k], (n, k, t[k], jt[k])
        # every key of the reference's record; no HLO on the port's side
        assert set(jrec) <= set(rec)
        assert rec["hlo_bytes"] is None
        assert set(rec["measured_by"]) == {
            "flops", "bytes accessed", "collective_bytes", "memory_analysis"}
        assert set(rec["collective_bytes"]) == set(jrec["collective_bytes"])
        mem = rec["memory_analysis"]
        assert "generated_code_size_in_bytes" not in mem
        assert mem["temp_size_in_bytes"] > 0


def test_whisper_decodes_measured_counts_against_the_references(runs):
    """What the counter measured, against the reference's record from
    the same run and against the config (the limits in the docstring)."""
    port, ref = runs
    for rec, jrec, want in zip(port["cells"], ref["cells"], port["want"]):
        mem, jmem = rec["memory_analysis"], jrec["memory_analysis"]
        unread = mem["unread_argument_size_in_bytes"]
        assert mem["argument_size_in_bytes"] == want["arguments"]
        assert unread == want["unread"] > 0
        assert mem["argument_size_in_bytes"] - unread == \
            jmem["argument_size_in_bytes"]
        ratio = rec["cost_analysis"]["flops"] / \
            rec["roofline"]["flops_per_device"]
        assert 0.9 <= ratio <= 3.5, ratio
        coll, jcoll = rec["collective_bytes"], jrec["collective_bytes"]
        assert jcoll["total"] / 8 <= coll["total"] <= jcoll["total"], \
            (coll, jcoll)
        assert coll["all-reduce"] > 0 and jcoll["all-reduce"] > 0
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k != "total")


def test_perf_variant_equals_the_references_for_every_config(runs):
    """The reference's, from its subprocess: importing its sweep sets its
    512-device XLA flag in the importing process."""
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.launch.optimized_sweep import perf_variant
    _, ref = runs
    assert set(ref["perf_variant"]) == set(ALL_ARCHS)
    for arch in ALL_ARCHS:
        t = perf_variant(get_config(arch))
        assert [t.flash_decode, t.local_recurrence,
                str(t.kv_cache_dtype).replace("torch.", "")] == \
            ref["perf_variant"][arch], arch


def _state():
    import repro_torch.configs as configs
    import repro_torch.launch.specs as specs
    import repro_torch.models.model as model
    return (model.PERF, specs.FSDP_THRESHOLD_BYTES,
            configs._REGISTRY["mixtral-8x7b"])


def _record():
    return {"roofline": {"compute_s": 1.0, "memory_s": 2.0,
                         "memory_analytic_s": 3.0, "collective_s": 4.0,
                         "bottleneck": "memory", "roofline_frac": 0.5},
            "collective_bytes": {"total": 5.0},
            "memory_analysis": {"argument_size_in_bytes": 6,
                                "temp_size_in_bytes": 7},
            "compile_s": 8.0}


def test_run_variant_and_perf_overrides_restore_the_state(monkeypatch,
                                                          tmp_path):
    import repro_torch.configs as configs
    import repro_torch.launch.dryrun as dryrun
    import repro_torch.launch.hillclimb as hillclimb
    import repro_torch.launch.optimized_sweep as sweep
    import repro_torch.launch.specs as specs
    import repro_torch.models.model as model
    monkeypatch.setattr(hillclimb, "RESULTS", tmp_path)
    before = _state()
    seen = {}

    def fake_run(arch, shape, **kw):
        seen["perf"] = model.PERF
        seen["thresh"] = specs.FSDP_THRESHOLD_BYTES
        seen["group"] = configs.get_config(arch).moe.group_size
        if kw.get("quant") == "int8":
            raise RuntimeError("planted failure")
        return _record()

    monkeypatch.setattr(dryrun, "run_cell", fake_run)
    row = hillclimb.run_variant(
        "mixtral-8x7b", "train_4k", "A4", "h", perf=dict(flash_decode=True),
        fsdp_threshold=1e18, config=hillclimb._group1024)
    assert seen == {"perf": model.PerfConfig(flash_decode=True),
                    "thresh": 1e18, "group": 1024}
    assert row["frac"] == 0.5 and row["arg_bytes"] == 6
    assert json.loads((tmp_path / "mixtral-8x7b_train_4k_A4.json")
                      .read_text())["variant"] == "A4"
    assert _state() == before
    with pytest.raises(RuntimeError, match="planted"):
        hillclimb.run_variant(
            "mixtral-8x7b", "train_4k", "x", "h", perf=dict(
                local_recurrence=True), fsdp_threshold=1.0,
            config=hillclimb._group1024, quant="int8")
    assert _state() == before
    with pytest.raises(ValueError):
        with sweep.perf_overrides(model.PerfConfig(flash_decode=True)):
            assert model.PERF.flash_decode
            raise ValueError
    assert _state() == before


def test_a_failing_cell_is_a_fail_and_exit_code_1(monkeypatch, capsys):
    import repro_torch.launch.dryrun as dryrun

    def fake_run(arch, shape, **kw):
        if shape == "prefill_32k":
            raise RuntimeError("planted failure")
        return {}

    monkeypatch.setattr(dryrun, "run_cell", fake_run)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama31-8b"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL [llama31-8b x prefill_32k x mp=False]" in out
    assert "2/3 cells ran" in out
    dryrun.main(["--arch", "llama31-8b", "--shape", "decode_32k",
                 "--both-meshes"])
    assert "2/2 cells ran" in capsys.readouterr().out
