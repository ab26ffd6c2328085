"""`BENCHMARK.json` against the benchmark's contract, and every file it
names: names and units in the allowed characters, each per-layer metric's
cells reporting the end-to-end metric it moves, each configuration used
by a cell, and a reader, a traffic file and a limits file where needed."""
import json
import math
import re

import pytest

from bench import manifest as mf

M = mf.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                    r"_rank$|expansion|experts_per_tok|width)")


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "bench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert 1 <= M["run_seconds"] <= 51
    n = 24
    assert (2 + 14 * n) * (M["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_keys():
    entries = M["configs"] + M["workloads"] + M["end_to_end"] + \
        M["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names)), group
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in M["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in M["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(e["layer"]) <= 200 and "\n" not in e["layer"]
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    assert any(e["name"] == "setup_s" for e in M["end_to_end"])


def test_cells_and_configs():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (mf.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = mf.load_limits(w["name"])
        assert all(math.isfinite(v) for v in limits.values())
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(M["paths"][0] + "/")
        cfile = mf.load_config_file(M, c["name"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k), k
            assert k in cfile and cfile["published"][k] != cfile[k]


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_what_its_layers_move(w):
    e2e = {m["name"] for m in mf.metrics_of(M, w, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = mf.metrics_of(M, w, trace=True)
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (w, m["name"])


@pytest.mark.parametrize("name", [m["name"] for m in M["per_layer"]])
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(mf.reader(name))
