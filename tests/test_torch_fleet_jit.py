"""The jit fleet backend against the reference's, on the CPU.

(a) `fleet_loop_ref` (the plain version of the fleet-loop kernel) against
    the reference's compiled phase (`repro.serving.fleet_jit.
    _compiled_phase`) on the same packed inputs: integers exactly, floats
    within `precision.jit_tolerance()`;
(b) `jit_run_points(device="cpu")` against the port's numpy fleet (the
    oracle) and against the reference's `jit_run_points`, with the fields
    that are not bitwise equal counted;
(c) routing: eligibility as the reference's, `on_result` for every lane,
    `JitFallback` at a tiny round cap, the execution backends;
(d) without a card, the jit entry points raise unless asked for the CPU.

The reference's jit path flips JAX's process-wide x64 flag, so it runs in
a subprocess (`JAX_PLATFORMS=cpu`) and hands back numpy arrays and record
dicts by pickle: the flag never reaches the other JAX parity tests of
this test process.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.experiments as texp
from repro.serving import fleet_jit as jjit
from repro.serving.fleet import FleetPoint as JFleetPoint
from repro_torch.experiments import plan as tplan
from repro_torch.experiments.runner import execute_cells
from repro_torch.kernels.fleet_loop import fleet_loop
from repro_torch.kernels.fleet_loop.ref import fleet_loop_ref
from repro_torch.serving import fleet_jit, precision
from repro_torch.serving.arrivals import synth_arrays
from repro_torch.serving.fleet import FleetPoint, fleet_run_points

SRC = Path(__file__).resolve().parents[1] / "src"

# the cases, as expressions over one side's `exp` (experiments) and `plan`
# (experiments.plan) modules, so that each side builds its own cells
CASES = {
    "mini_2x2": "list(exp.get_plan('mini_2x2').cells)",
    "mini_crosshw": "list(exp.get_plan('mini_crosshw').cells)",
    "mini_ensemble": "list(exp.get_plan('mini_ensemble').cells)",
    # short streams: a horizon cut, a lambda-1 idle lane, mixtral on 2
    "short": ("list(plan.ladder_plan(ladder=(1, 40), horizon=3.0, "
              "arch='mixtral-8x7b', model='mixtral-8x7b', hw='tpu-v5e', "
              "n_chips=2, requests_per_point=lambda lam: 60, "
              "warmup_per_point=lambda lam: 0).cells)"),
}
POINTS = (
    "[FleetPoint(engine=c.engine_spec(), arrivals=c.arrival_spec(), "
    "warmup=c.warmup, horizon=c.horizon, failure_times=c.failure_times, "
    "failure_spec=c.failure_spec(), retry=c.retry_policy(), "
    "**c.record_kw()) for c in cells]")

_REF_CODE = r"""
import dataclasses, pickle, sys
import numpy as np
req = pickle.load(sys.stdin.buffer)
from repro.serving import precision
assert precision.enable_x64()
import jax.numpy as jnp
import repro.experiments as exp
from repro.experiments import plan
from repro.serving.fleet import FleetPoint
from repro.serving.fleet_jit import _compiled_phase, jit_run_points
out = {"phases": [], "records": {}}
for md, ec, r_arr, ilog_n, ilog_k, cap in req["phases"]:
    res = _compiled_phase(ilog_n, ilog_k, cap)(
        {k: jnp.asarray(v) for k, v in md.items()},
        {k: jnp.asarray(v) for k, v in ec.items()}, jnp.asarray(r_arr))
    out["phases"].append([np.asarray(a) for a in res])
for name, expr in req["cases"].items():
    cells = eval(expr)
    pts = eval(req["points"])
    out["records"][name] = [dataclasses.asdict(r)
                            for r in jit_run_points(pts)]
pickle.dump(out, sys.stdout.buffer)
"""
PHASE_OUT = ("live", "stall", "t", "area", "ncomp", "crd", "ne", "QadmE",
             "TfirstE", "TfinE")


def _port_points(case):
    exp, plan = texp, tplan                           # noqa: F841
    cells = eval(CASES[case])                         # noqa: F841
    return eval(POINTS)


def _packed(case):
    pts = _port_points(case)
    streams = [synth_arrays(p.arrivals) for p in pts]
    ids = [i for i, p in enumerate(pts)
           if fleet_jit.jit_eligible(p, streams[i])]
    assert len(ids) == len(pts)
    md, ec, r_arr, cap, _up, umn, _n = fleet_jit._pack(
        pts, [streams[i] for i in ids])
    ilog_n = r_arr.shape[1].bit_length()
    ilog_k = max(1, int(umn.max())).bit_length()
    return md, ec, r_arr, ilog_n, ilog_k, cap


@pytest.fixture(scope="module")
def reference():
    """The reference's compiled phase on each case's packed inputs, and
    its `jit_run_points` records, from one subprocess."""
    req = {"phases": [_packed(c) for c in CASES], "cases": CASES,
           "points": POINTS}
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_CODE],
                         input=pickle.dumps(req), capture_output=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    out = pickle.loads(res.stdout)
    out["packed"] = req["phases"]
    return out


def _close(a, b) -> bool:
    rtol, atol = precision.X64_TOLERANCE
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return math.isclose(a, b, rel_tol=rtol, abs_tol=atol)


def _compare_records(oracle, got, ctx):
    """Every non-float field exactly equal, every float field within the
    x64 tolerance; returns (float fields, fields not bitwise equal)."""
    assert len(oracle) == len(got) > 0
    n_float = inexact = 0
    for a, b in zip(oracle, got):
        da = a if isinstance(a, dict) else dataclasses.asdict(a)
        db = b if isinstance(b, dict) else dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for key in da:
            va, vb = da[key], db[key]
            if isinstance(va, float):
                n_float += 1
                inexact += repr(va) != repr(vb)
                assert _close(va, vb), (ctx, da["lam"], key, va, vb)
            else:
                assert va == vb, (ctx, da["lam"], key, va, vb)
    return n_float, inexact


@pytest.mark.parametrize("case", list(CASES))
def test_plain_loop_matches_reference_phase(reference, case):
    i = list(CASES).index(case)
    md, ec, r_arr, _n, _k, cap = reference["packed"][i]
    got = fleet_loop_ref({k: torch.as_tensor(v) for k, v in md.items()},
                         {k: torch.as_tensor(v) for k, v in ec.items()},
                         torch.as_tensor(r_arr), cap)
    ref = dict(zip(PHASE_OUT, reference["phases"][i]))
    W = r_arr.shape[1]
    assert not ref["live"].any() and not got["live"].any()
    rtol, atol = precision.jit_tolerance()
    for k in PHASE_OUT:
        a, b = ref[k], got[k].numpy()
        if a.ndim == 2:               # the dump column holds scratch
            a, b = a[:, :W - 1], b[:, :W - 1]
        if a.dtype.kind == "f":
            assert np.allclose(b, a, rtol=rtol, atol=atol), k
        else:
            assert np.array_equal(a, b), k
    assert got["rounds"].max() > 1


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_jit_records_match_numpy_and_reference(reference, case):
    pts = _port_points(case)
    oracle = fleet_run_points(pts)
    seen = []
    before = dict(fleet_jit.LANES)
    got = fleet_jit.jit_run_points(pts, on_result=lambda j, r: seen.append(j),
                                   device="cpu")
    assert sorted(seen) == list(range(len(pts)))
    assert fleet_jit.LANES["loop"] - before["loop"] == len(pts)
    assert fleet_jit.LANES["fallback"] == before["fallback"]
    # against the numpy oracle: bit for bit, as found on every case
    n_float, inexact = _compare_records(oracle, got, case)
    assert n_float == 17 * len(pts) and inexact == 0
    # against the reference's jit records: within its tolerance
    _compare_records(reference["records"][case], got, case)


def _eligibility_points(fp_cls, exp, plan):
    cells = list(exp.get_plan("mini_resilience").cells)
    cells += list(plan.ladder_plan(ladder=(5,), failure_times=[0.5],
                                   arch="llama31-8b", hw="tpu-v5e").cells)
    cells += [dataclasses.replace(c, max_pages_per_seq=512, num_pages=131072)
              for c in plan.ladder_plan(ladder=(10,), io_shape="variable",
                                        arch="llama31-8b",
                                        hw="tpu-v5e").cells]
    cells += list(exp.get_plan("mini_flashcrowd").cells)
    cells += list(exp.get_plan("mini_2x2").cells)
    return [fp_cls(engine=c.engine_spec(), arrivals=c.arrival_spec(),
                   warmup=c.warmup, horizon=c.horizon,
                   failure_times=c.failure_times,
                   failure_spec=c.failure_spec(), retry=c.retry_policy(),
                   **c.record_kw()) for c in cells]


def test_eligibility_matches_reference():
    import repro.experiments as jexp
    from repro.experiments import plan as jplan
    from repro.serving.arrivals import synth_arrays as jsynth
    jpts = _eligibility_points(JFleetPoint, jexp, jplan)
    tpts = _eligibility_points(FleetPoint, texp, tplan)
    want = [jjit.jit_eligible(p, jsynth(p.arrivals)) for p in jpts]
    got = [fleet_jit.jit_eligible(p, synth_arrays(p.arrivals))
           for p in tpts]
    assert got == want
    assert any(want) and not all(want)
    # the ineligible points ride the numpy fleet inside jit_run_points
    before = fleet_jit.LANES["numpy"]
    recs = fleet_jit.jit_run_points(tpts, device="cpu")
    assert fleet_jit.LANES["numpy"] - before == want.count(False)
    n_float, inexact = _compare_records(fleet_run_points(tpts), recs,
                                        "eligibility")
    assert inexact == 0


def test_round_cap_falls_back_to_numpy(monkeypatch):
    pts = _port_points("mini_2x2")
    monkeypatch.setattr(fleet_jit, "_CAP_FLOOR", 1)
    monkeypatch.setattr(fleet_jit, "_CAP_PER_REQ", 0)
    with pytest.raises(fleet_jit.JitFallback, match="did not converge"):
        fleet_jit._run_jit_fleet(pts, [synth_arrays(p.arrivals)
                                       for p in pts], "cpu")
    before = fleet_jit.LANES["fallback"]
    recs = fleet_jit.jit_run_points(pts, device="cpu")
    assert fleet_jit.LANES["fallback"] - before == len(pts)
    assert [repr(r) for r in recs] == [repr(r)
                                       for r in fleet_run_points(pts)]


def test_on_the_card_a_chunk_the_loop_does_not_finish_raises(monkeypatch):
    # the card's path with the plain loop standing in for the kernel: a
    # lane still live at the cap raises instead of re-running on numpy
    pts = _port_points("mini_2x2")
    monkeypatch.setattr(fleet_jit, "_CAP_FLOOR", 1)
    monkeypatch.setattr(fleet_jit, "_CAP_PER_REQ", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    run = fleet_jit._run_jit_fleet
    devices = []

    def on_cpu(points, streams, device):
        devices.append(device)
        return run(points, streams, "cpu")
    monkeypatch.setattr(fleet_jit, "_run_jit_fleet", on_cpu)
    before = dict(fleet_jit.LANES)
    with pytest.raises(fleet_jit.JitFallback, match="did not converge"):
        fleet_jit.jit_run_points(pts)
    assert [d.type for d in devices] == ["cuda"]
    assert fleet_jit.LANES == before


def test_jit_backend_on_cpu_matches_vector_backend():
    plan = texp.get_plan("mini_crosshw")
    vector = texp.PlanRunner(plan).run(parallel=False, backend="vector")
    serial = texp.PlanRunner(plan).run(parallel=False, backend="jit",
                                       device="cpu")
    _compare_records(vector, serial, "jit-serial")
    # on the CPU the jit backend keeps the pool (work-stolen chunks; 32
    # lanes are two minimum-width chunks)
    cells = list(plan.cells) + list(texp.get_plan("mini_ensemble").cells)
    pooled = execute_cells(cells, parallel=True, max_workers=2,
                           backend="jit", lane_width=6, device="cpu")
    _compare_records(execute_cells(cells, parallel=False, backend="vector"),
                     pooled, "jit-pool")


def test_without_a_card_the_jit_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _port_points("mini_2x2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_jit.jit_run_points(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_jit.jit_run_points(pts, device="cuda")
    cells = list(texp.get_plan("mini_2x2").cells)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_cells(cells, parallel=False, backend="jit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texp.PlanRunner(texp.get_plan("mini_2x2")).run(backend="jit")


def test_fleet_loop_dispatch_refuses_other_devices():
    md, ec, r_arr, _n, _k, cap = _packed("mini_2x2")
    with pytest.raises(ValueError, match="no version for device"):
        fleet_loop({k: torch.as_tensor(v, device="meta")
                    for k, v in md.items()},
                   {k: torch.as_tensor(v, device="meta")
                    for k, v in ec.items()},
                   torch.as_tensor(r_arr, device="meta"), cap)


def test_precision_policy_keeps_the_reference_api(monkeypatch):
    assert precision.enable_x64() and precision.enable_x64()
    assert precision.active_x64()
    assert precision.jit_tolerance() == precision.X64_TOLERANCE == \
        (1e-9, 1e-12)
    monkeypatch.setitem(precision._STATE, "enabled", False)
    assert precision.jit_tolerance() == precision.F32_TOLERANCE
