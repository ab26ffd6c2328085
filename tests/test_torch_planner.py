"""The port's named plans, analyses, run CLI and planner against the
reference's.

All numpy on both sides, so exact equality:
(a) every plan of `PLANS` expands to the same cells, seeds, ids and spec
    hashes;
(b) `analyze.report` text and the `write_tables` JSON, byte for byte, on
    the committed `paper_h100`, `paper_crosshw`, `paper_atlas` and
    `paper_ensemble` stores (a fresh derivation on each side; the stores
    are only read), and `ensemble_bands` on the ensemble store;
(c) `python -m repro_torch.planner` text in its plan and portfolio modes,
    and its `--json`;
(d) `experiments.run --plan mini_2x2 --backend vector` into a temporary
    root: the same consolidated CSV, byte for byte (and with
    `--backend jit --device cpu` too, whose records are bitwise equal).
"""
import dataclasses
import json

import pytest

import repro.experiments.analyze as janalyze
import repro.experiments.plans as jplans
import repro.experiments.run as jrun
import repro.planner.__main__ as jplanner
import repro_torch.experiments.analyze as tanalyze
import repro_torch.experiments.plans as tplans
import repro_torch.experiments.run as trun
import repro_torch.planner.__main__ as tplanner

STORES = ("paper_h100", "paper_crosshw", "paper_atlas", "paper_ensemble")


@pytest.mark.parametrize("name", sorted(jplans.PLANS))
def test_plan_cells_and_hashes_match_reference(name):
    assert sorted(tplans.PLANS) == sorted(jplans.PLANS)
    ref, port = jplans.get_plan(name), tplans.get_plan(name)
    assert (port.name, port.description) == (ref.name, ref.description)
    assert len(port.cells) == len(ref.cells) > 0
    for a, b in zip(ref.cells, port.cells):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert (b.cell_id, b.seed, b.fingerprint(), b.group_key) == \
            (a.cell_id, a.seed, a.fingerprint(), a.group_key)


@pytest.fixture(scope="module")
def store_records():
    """{store: (reference records, port records)}, each side loading the
    committed store with its own package."""
    return {name: (janalyze.load_store_records(name),
                   tanalyze.load_store_records(name)) for name in STORES}


@pytest.mark.parametrize("name", STORES)
def test_report_and_tables_match_reference(store_records, name, tmp_path):
    ref, port = store_records[name]
    assert len(port) == len(ref) > 0
    assert tanalyze.report(port, title=name) == \
        janalyze.report(ref, title=name)
    janalyze.write_tables(ref, tmp_path / "ref.json")
    tanalyze.write_tables(port, tmp_path / "port.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


def test_ensemble_bands_match_reference(store_records):
    ref, port = store_records["paper_ensemble"]
    bands = tanalyze.ensemble_bands(port)
    assert bands and json.dumps(bands, sort_keys=True) == \
        json.dumps(janalyze.ensemble_bands(ref), sort_keys=True)


def _cli(main, argv, capsys):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--plan", "paper_atlas", "--lam", "5", "--slo-ttft-p90", "2000"],
    ["--plan", "paper_atlas", "--portfolio", "blended_3class"],
    ["--plan", "paper_crosshw", "--lam", "40", "--model", "mixtral-8x7b",
     "--availability", "0.999"],
])
def test_planner_cli_text_matches_reference(argv, capsys, tmp_path):
    ref = _cli(jplanner.main, argv + ["--json", str(tmp_path / "r.json")],
               capsys)
    port = _cli(tplanner.main, argv + ["--json", str(tmp_path / "p.json")],
                capsys)
    assert port[0] == ref[0]
    assert port[1].replace(str(tmp_path / "p.json"), "J") == \
        ref[1].replace(str(tmp_path / "r.json"), "J")
    assert len(port[1].splitlines()) > 5
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()


def test_run_cli_csv_matches_reference(tmp_path, capsys):
    args = ["--plan", "mini_2x2", "--serial", "--analyze"]
    assert jrun.main(args + ["--backend", "vector", "--root",
                             str(tmp_path / "ref")]) is None
    ref_out = capsys.readouterr().out
    assert trun.main(args + ["--backend", "vector", "--root",
                             str(tmp_path / "port")]) is None
    port_out = capsys.readouterr().out
    csv = tmp_path / "port" / "mini_2x2" / "mini_2x2.csv"
    assert csv.read_bytes() == \
        (tmp_path / "ref" / "mini_2x2" / "mini_2x2.csv").read_bytes()
    # the report after the run is the same text
    assert port_out.split("cells consolidated")[1].split("\n", 2)[2] == \
        ref_out.split("cells consolidated")[1].split("\n", 2)[2]
    assert trun.main(args + ["--backend", "jit", "--device", "cpu",
                             "--root", str(tmp_path / "jit")]) is None
    assert (tmp_path / "jit" / "mini_2x2" / "mini_2x2.csv").read_bytes() \
        == csv.read_bytes()
