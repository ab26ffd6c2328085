"""The controls and the planted faults at each cell's own size, on the
card (skipped without one): the configuration's precision passes its
limits on each seed; the nearest precision below it, and the timed path
with one slot serving garbage or half of the batch left out, do not. Run
on the card with

    BENCH_CARD_LOG=chiprun_out/card.jsonl \\
        python3 -m pytest -m cuda bench/test_bench_card.py

(a run of the cell a case, about two minutes each). With
`BENCH_CARD_LOG` set, each case appends its readings there as one JSON
line. `bench/control.py` reads the sound runs and the controls on more
seeds.
"""
import json
import os

import pytest

from bench import faults, manifest as mf

M = mf.load_manifest()
SEEDS = (2 ** 31 + 1001, 2 ** 31 + 1002, 2 ** 31 + 1003)
CELLS = [w["name"] for w in M["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full width")
    from bench import run
    run.caches()
    return run


def _log(case: str, workload: str, seed: int, r: dict):
    path = os.environ.get("BENCH_CARD_LOG")
    if not path:
        return
    from bench import run
    row = {"case": case, "workload": workload, "seed": seed,
           "correct": r["correct"], "checks": r["checks"],
           "control": r.get("control"),
           **{k: v for k, v in r["reference"].items() if k[0] != "_"}}
    with open(path, "a") as f:
        f.write(json.dumps(run.finite(row)) + "\n")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, workload, seed):
    from bench import control, reference
    from repro_torch.configs import get_config
    cfile = mf.load_config_file(M, mf.cell(M, workload)["config"])
    cfg = mf.model_config(cfile, get_config(cfile["arch"]))
    lower = control.CONTROL[cfile["quant"]]
    seconds = M["run_seconds"]
    if reference.coupled(cfg, cfile["quant"]):
        # the reference in the lower precision, in the program's place
        r = card.run_cell(workload, seed, seconds, False, control=lower)
        _log("sound+control", workload, seed, r)
        assert r["correct"], r["checks"]
        assert not r["control"]["correct"], r["control"]
    else:
        # the program's own path in the lower precision
        r = card.run_cell(workload, seed, seconds, False)
        _log("sound", workload, seed, r)
        assert r["correct"], r["checks"]
        c = card.run_cell(workload, seed, seconds, False, quant=lower)
        _log("control", workload, seed, c)
        assert not c["correct"], c["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_is_not_correct_on_the_card(card, workload, kind,
                                                  seed):
    from repro_torch.configs import get_config
    cfile = mf.load_config_file(M, mf.cell(M, workload)["config"])
    cfg = mf.model_config(cfile, get_config(cfile["arch"]))
    r = card.run_cell(workload, seed, M["run_seconds"], False,
                      fault=faults.by_name(kind, cfg.vocab_size, seed))
    _log(kind, workload, seed, r)
    assert not r["correct"], r["checks"]
