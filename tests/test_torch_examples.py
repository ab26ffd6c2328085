"""The port's examples (`examples/torch_*.py`) against the reference's
(`examples/*.py`), on the CPU.

- Each of the seven report examples prints the reference example's text.
  Both packages' `experiments.store.DEFAULT_ROOT` point at one copy of the
  committed stores in `tmp_path`; the port's examples write under their
  own `EXAMPLES_ROOT`, also in `tmp_path`. Store paths are normalised, and
  so are the port's `repro_torch ... --root` commands in the advice lines.
  The port runs first, so a plan with no committed store
  (`crossover_trio`) is run by both sides.
- `torch_serve_cost_meter.py --skip-real --hw tpu-v5p` prints what the
  reference's example prints with `--skip-real`, exactly.
- Its real half on the CPU finishes every request and conserves tokens
  (its times are wall clock, so they are not compared).
- No example of the port imports `repro`, and nothing under `results/`
  changes.
"""
import ast
import importlib.util
import runpy
import shutil
import sys
from pathlib import Path

import pytest

import repro.experiments.store as jstore
import repro_torch.experiments.store as tstore

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
RESULTS = ROOT / "results"
REPORTS = ("quickstart", "crossover_report", "penalty_atlas_report",
           "crosshw_report", "capacity_plan_report", "portfolio_report",
           "day_cost_report")


def _snapshot(root: Path):
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*") if p.is_file()}


@pytest.fixture(autouse=True)
def results_untouched():
    before = _snapshot(RESULTS)
    yield
    assert _snapshot(RESULTS) == before, "an example wrote under results/"


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """One copy of the committed stores for both packages, and the port's
    examples' own root; returns (copy, examples' root)."""
    copy, own = tmp_path / "committed", tmp_path / "examples_out"
    shutil.copytree(RESULTS / "experiments", copy)
    monkeypatch.setattr(jstore, "DEFAULT_ROOT", copy)
    monkeypatch.setattr(tstore, "DEFAULT_ROOT", copy)
    monkeypatch.setattr(tstore, "EXAMPLES_ROOT", own)
    return copy, own


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_port(name, argv, capsys) -> str:
    _load(name).main(argv)
    return capsys.readouterr().out


def _run_reference(name, argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _normalised(text: str, root: Path) -> str:
    return (text.replace(str(root), "<store>")
            .replace(" --root examples_out/experiments", "")
            .replace("repro_torch.", "repro."))


@pytest.mark.parametrize("name", REPORTS)
def test_report_example_prints_the_references_text(name, stores, capsys,
                                                   monkeypatch):
    copy, own = stores
    port = _run_port(name, [], capsys)
    ref = _run_reference(name, [], capsys, monkeypatch)
    assert ref.strip()
    assert _normalised(port, own) == _normalised(ref, copy)


def test_report_examples_move_onto_another_entry(stores, capsys):
    """`--hw h100-sxm` runs the one-generation plans on that entry and adds
    it to the cross-hardware ones; the committed copy stays as it was."""
    copy, own = stores
    before = _snapshot(copy)
    out = _run_port("quickstart", ["--hw", "h100-sxm"], capsys)
    assert "on h100-sxm ($2.99/chip-hr) — 0/6 cells" in out
    out = _run_port("crosshw_report", ["--hw", "h100-sxm"], capsys)
    assert "paper_crosshw: 126/168 cells" in out and "  h100-sxm " in out
    assert _snapshot(copy) == before
    assert (own / "quickstart_on_h100_sxm").is_dir()


def test_cost_meter_sim_half_prints_the_references(capsys, monkeypatch):
    port = _run_port("serve_cost_meter", ["--skip-real", "--hw", "tpu-v5p"],
                     capsys)
    ref = _run_reference("serve_cost_meter", ["--skip-real"], capsys,
                         monkeypatch)
    assert "10440/10440 ok" in ref
    assert port == ref


def test_cost_meter_real_half_on_the_cpu_conserves_tokens(capsys):
    eng, meter, reqs = _load("serve_cost_meter").real_half(
        "cpu", phase_s=10.0)
    out = capsys.readouterr().out
    assert len(reqs) == 100
    assert all(r.finish_time is not None for r in reqs)
    assert eng.metrics.get("repro:generation_tokens_total") == \
        sum(r.max_new_tokens for r in reqs)
    assert meter.summary()["time_weighted_avg"] > 0
    assert "priced at cpu-node" in out and "real: 100/100 ok" in out


def test_live_phases_reads_each_phase():
    """`chip_smoke.py` phase 8's per-phase readings, on requests made by
    hand: two phases of 2 and 4 requests (rates 1 and 2 at 2 s each)."""
    from types import SimpleNamespace

    from repro_torch.serving import Request
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    times = [(0.0, 0.1), (1.0, 1.2), (1.5, 2.0), (1.6, 2.5), (1.7, 3.0),
             (1.8, 1.9)]
    reqs = [Request(i, a, 8, 4, first_token_time=f)
            for i, (a, f) in enumerate(times)]
    ticks = [SimpleNamespace(t=t, inflight=n)
             for t, n in ((0.5, 1), (1.55, 3), (2.0, 5))]
    one, two = chip_smoke._live_phases((1, 2), 2.0, reqs, ticks)
    assert (one["requests"], one["from_s"], one["peak_in_flight"],
            one["peak_waiting"]) == (2, 0.0, 1, 1)
    assert one["ttft_p50_ms"] == pytest.approx(200.0)
    assert (two["requests"], two["from_s"], two["peak_in_flight"],
            two["peak_waiting"]) == (4, 1.5, 5, 4)
    assert two["ttft_p50_ms"] == pytest.approx(900.0)


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("torch_*.py")),
                         ids=lambda p: p.name)
def test_port_examples_import_no_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            assert n.split(".")[0] not in ("repro", "jax"), (path.name, n)
