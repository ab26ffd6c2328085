"""The CPU rehearsal of `nemotron-4-15b-bf16.coding-steady`
(`bench/rehearsal.py`): the harness's whole run but the look for a card,
on a narrow model through the plain kernels.

- A sound run is correct: the reference agrees with the program but for
  a rare near-tie, every finished request got its tokens, the meter
  agrees with the harness.
- The control, the program's own int8 path, comes out not correct at the
  limit the CPU's agreement allows (0): its tokens part from the bf16
  reference's.
- The planted faults, a token altered where it is produced, one slot
  serving garbage, and half of the batch left out, come out not correct
  at the cell's own limits.
"""
import math

import pytest

from bench import faults, rehearsal

W = "nemotron-4-15b-bf16.coding-steady"


def test_sound_run_is_correct():
    r = rehearsal.run(W)
    assert r["correct"], r["checks"]
    assert r["reference"]["mismatch_share"] < 0.05
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = r["metrics"]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in e2e.values())


def test_planted_fault_is_not_correct():
    r = rehearsal.run(W, d_model=512, fault=faults.altered())
    assert not r["correct"]
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


@pytest.mark.parametrize("kind", faults.KINDS)
def test_slot_fault_is_not_correct(kind):
    r = rehearsal.run(W, d_model=512, fault=faults.by_name(kind, 1024, 3))
    assert not r["correct"]
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_control_is_not_correct():
    """bf16's control: the program's own int8 path, judged against the
    bf16 reference."""
    r = rehearsal.run(W, quant="int8",
                      limits={"max_gap": 0.0, "meter_rel": 1e-6})
    assert not r["correct"]
    assert r["checks"]["max_gap"]["value"] > 0.0


def test_traced_run_reads_its_layers():
    from bench import run as run_lib
    r = run_lib.run_cell(W, 11, 3.0, True, device="cpu",
                         configure=rehearsal.narrow(),
                         mix=rehearsal.short(W), log=lambda *a: None)
    m = r["metrics"]
    assert 0 < m["prefill_useful_share.steady"]["value"] <= 100
    assert m["prefill_call_ms.steady"]["value"] > 0
    assert m["ttft_p90_ms.steady"]["value"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
