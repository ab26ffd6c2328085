"""The port's sweep, records and experiment runner against the reference's.

All numpy on both sides, so exact equality (a NaN matches a NaN):
(d) `lambda_sweep` records, and `parallel_sweep(backend="process")`
    equal to the serial sweep;
(e) `crossover_table`, `slo_operating_point` and `stability_table`;
(f) CSVs: each side reads the other's, and both write the same bytes;
(g) `Cell` seeds, ids and spec hashes of a ladder plan and a grid;
(h) the `ExperimentStore` files of a small plan, byte for byte.
Port-only: a sim-only process of the port, the fleet's vector backend
included, never imports torch.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as jcore
import repro.experiments as jexp
import repro_torch.core as tcore
import repro_torch.experiments as texp
from repro.experiments.plan import smoke_requests_per_point as j_smoke
from repro_torch.experiments.plan import smoke_requests_per_point as t_smoke
from repro_torch.experiments.plan import zero_warmup

SRC = Path(__file__).resolve().parents[1] / "src"
LADDER = (1, 10, 50)


def _canon(x):
    """A value with every NaN made comparable (NaN == NaN here)."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _canon(dataclasses.asdict(x))
    return x


def _sweep(core, seed=0, hw="tpu-v5e", **kw):
    fac = core.SimEngineSpec("llama31-8b", hw=hw, max_batch=64,
                             num_pages=8192)
    return core.lambda_sweep(
        fac, ladder=LADDER, requests_per_point=lambda lam: 80,
        warmup_per_point=lambda lam: 5, seed=seed, config="C1",
        model="llama31-8b", hw=hw, price_per_hr=core.chip_hour_price(hw),
        **kw)


@pytest.fixture(scope="module")
def sweeps():
    """{seed: (reference records, port records)} over LADDER."""
    return {s: (_sweep(jcore, s), _sweep(tcore, s)) for s in (0, 1)}


def test_lambda_sweep_records_match_reference(sweeps):
    for ref, port in sweeps.values():
        assert len(port) == len(LADDER)
        assert _canon(port) == _canon(ref)
        assert all(r.n_completed == r.n_requests for r in port)
        assert port[-1].penalty == ref[-1].penalty


def test_parallel_sweep_matches_serial_sweep():
    fac = tcore.SimEngineSpec("qwen3-30b-a3b", hw="h100-sxm", quant="fp8",
                              max_batch=64, num_pages=8192)
    kw = dict(ladder=LADDER, requests_per_point=t_smoke,
              warmup_per_point=zero_warmup, config="q", model="q",
              hw="h100-sxm", quant="fp8",
              price_per_hr=tcore.chip_hour_price("h100-sxm"))
    serial = tcore.lambda_sweep(fac, **kw)
    par = tcore.parallel_sweep(fac, max_workers=2, backend="process", **kw)
    assert _canon(par) == _canon(serial)
    assert [r.lam for r in par] == list(LADDER)


def test_analyses_match_reference(sweeps):
    (ref0, port0), (ref1, port1) = sweeps[0], sweeps[1]
    tiers = {"cheap": jcore.APITier("cheap", 0.1, 0.2),
             "dear": jcore.APITier("dear", 5.0, 30.0)}
    ttiers = {k: tcore.APITier(**dataclasses.asdict(v))
              for k, v in tiers.items()}
    for tt, jt in ((None, None), (ttiers, tiers)):
        assert _canon(tcore.crossover_table(port0, tt,
                                            accept_slo_mismatch=True)) == \
            _canon(jcore.crossover_table(ref0, jt, accept_slo_mismatch=True))
    with pytest.raises(ValueError, match="gated"):
        tcore.crossover_table(port0)
    for bounds in ((), (300.0, 50.0), (1e9, 1e9), (0.0, 0.0)):
        assert _canon(tcore.slo_operating_point(port0, *bounds)) == \
            _canon(jcore.slo_operating_point(ref0, *bounds))
    assert tcore.interp_c_eff(port0, 3.3) == jcore.interp_c_eff(ref0, 3.3)
    by_lam = {lam: [a, b] for lam, a, b in zip(LADDER, ref0, ref1)}
    tby_lam = {lam: [a, b] for lam, a, b in zip(LADDER, port0, port1)}
    assert _canon(tcore.stability_table(tby_lam)) == \
        _canon(jcore.stability_table(by_lam))


def test_csv_reads_back_across_packages(sweeps, tmp_path):
    ref, port = sweeps[0]
    tcore.write_csv(tmp_path / "port.csv", port)
    jcore.write_csv(tmp_path / "ref.csv", ref)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    assert _canon(jcore.read_csv(tmp_path / "port.csv")) == _canon(ref)
    assert _canon(tcore.read_csv(tmp_path / "ref.csv")) == _canon(port)


def _mini(exp, **over):
    kw = dict(name="mini", archs=("llama31-8b", "mixtral-8x7b"),
              hws=("tpu-v5e", "tpu-v5p"), quants=("bf16", "fp8"),
              ladder=(5, 50), n_chips_by_arch=(("mixtral-8x7b", 2),),
              seed=3, protocol="smoke", max_batch=64, num_pages=8192)
    kw.update(over)
    return exp.GridSpec(**kw).expand()


@pytest.mark.parametrize("over", [{}, dict(protocol="paper", seed=0),
                                  dict(mttfs=(0.0, 600.0),
                                       retry_maxes=(0, 2),
                                       seed_offsets=(0, 1))])
def test_grid_cells_seeds_and_hashes_match_reference(over):
    ref, port = _mini(jexp, **over), _mini(texp, **over)
    assert len(port) == len(ref) > 0
    for a, b in zip(ref.cells, port.cells):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert (b.cell_id, b.seed, b.fingerprint(), b.group_key) == \
            (a.cell_id, a.seed, a.fingerprint(), a.group_key)


def test_ladder_plan_cells_match_reference():
    kw = dict(ladder=(1, 2.5, 25), seed=11, config="C2", hw="h100-sxm",
              price_per_hr=2.0, failure_times=(3.0,))
    from repro.experiments.plan import ladder_plan as jladder
    from repro_torch.experiments.plan import ladder_plan as tladder
    ref, port = jladder(**kw), tladder(**kw)
    for a, b in zip(ref.cells, port.cells):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert (b.cell_id, b.seed, b.fingerprint()) == \
            (a.cell_id, a.seed, a.fingerprint())


def test_store_files_are_byte_identical(tmp_path):
    def run(exp, root):
        plan = _mini(exp, archs=("llama31-8b",), hws=("tpu-v5e",))
        store = exp.ExperimentStore(plan.name, root)
        recs = exp.PlanRunner(plan, store=store).run(parallel=False)
        return recs, {p.relative_to(root): p.read_bytes()
                      for p in sorted(root.rglob("*")) if p.is_file()}
    ref_recs, ref_files = run(jexp, tmp_path / "ref")
    recs, files = run(texp, tmp_path / "port")
    assert len(files) == 4 + 2          # 4 cells, the CSV, the manifest
    assert files == ref_files
    assert _canon(recs) == _canon(ref_recs)


def test_sim_only_process_never_imports_torch():
    """A sim-tier sweep of the port runs in a process that holds no torch,
    and its pool forks (the runner forks only a torch-free parent); so
    does a plan on the fleet's vector backend, serial and pooled."""
    code = (
        "import sys\n"
        "from repro_torch.core.sweep import SimEngineSpec, run_point, "
        "parallel_sweep\n"
        "from repro_torch.experiments.runner import default_mp_context\n"
        "from repro_torch.serving import ArrivalSpec\n"
        "rec = run_point(SimEngineSpec('llama31-8b', hw='h100-sxm'), "
        "ArrivalSpec(lam=5.0, n_requests=20, seed=1), hw='h100-sxm')\n"
        "assert rec.n_completed == 20, rec\n"
        "recs = parallel_sweep(SimEngineSpec('llama31-8b', hw='h100-sxm'), "
        "ladder=(1, 10), requests_per_point=lambda lam: 20, "
        "warmup_per_point=lambda lam: 0, max_workers=2)\n"
        "assert [r.n_completed for r in recs] == [20, 20], recs\n"
        "from repro_torch.experiments import PlanRunner, get_plan\n"
        "from repro_torch.experiments.runner import execute_cells\n"
        "plan = get_plan('mini_crosshw')\n"
        "recs = PlanRunner(plan).run(parallel=False, backend='vector')\n"
        "assert len(recs) == 16 and all(r.n_completed for r in recs)\n"
        "cells = list(plan.cells) + list(get_plan('mini_ensemble').cells)\n"
        "recs = execute_cells(cells, parallel=True, max_workers=2, "
        "backend='vector')\n"
        "assert len(recs) == 32, recs\n"
        "print(default_mp_context())\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'repro'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "print(default_mp_context())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["fork", "spawn"]
