"""`chip_smoke.py`'s card-vs-CPU verdicts for mixtral-8x7b in int8,
jamba-v0.1-52b in int8 and xlstm-350m in bf16, run on the CPU with both sides on the CPU
(`scripts/small_check_sensitivity.py`): identical sides pass, rounding
noise (one bf16 step on a share of the operations' results, as dense as
an H100's differences from the CPU) passes, and each planted fault
fails. Imports no JAX.
"""
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "small_check_sensitivity.py"
sys.path.insert(0, str(ROOT))                 # chip_smoke.py

import chip_smoke  # noqa: E402


def _sensitivity():
    spec = importlib.util.spec_from_file_location("small_check_sensitivity",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,quant,passing,failing", [
    # seed 1: a token of layer 0 routes differently and moves its layer-1
    # K/V by 1.1, which the verdict allows
    ("mixtral-8x7b", "int8",
     ["MoE input, 100% nudged", "as an H100 rounds, seed 1"],
     ["decode drops each context's last page"]),
    # seed 3: the fewest tokens equal of the eight seeds; the carried h
    # dropped is seen by the h bound alone
    ("jamba-v0.1-52b", "int8",
     ["MoE output, 100% nudged", "as an H100 rounds, seed 3"],
     ["decode drops the carried Mamba h",
      "decode drops the carried Mamba conv"]),
    # seed 4: the largest sLSTM n of the eight seeds
    ("xlstm-350m", "bf16", ["as an H100 rounds, seed 4"],
     ["decode drops the carried mlstm state",
      "decode drops the carried slstm state"]),
])
def test_verdict_passes_rounding_noise_and_fails_faults(arch, quant, passing,
                                                        failing):
    seen = {name: ok for name, ok, _ in _sensitivity().run(
        arch, quant, set(passing + failing))}
    assert set(seen) == set(passing + failing)
    for name in passing:
        assert seen[name], name
    for name in failing:
        assert not seen[name], name


@pytest.mark.parametrize("arch,quant", [("mixtral-8x7b", "int8"),
                                        ("jamba-v0.1-52b", "int8"),
                                        ("xlstm-350m", "bf16")])
def test_identical_sides_pass(arch, quant):
    cfg, params = chip_smoke.small_model(arch, quant)
    sides = chip_smoke.drive_small(cfg, quant, params,
                                   {"a": "cpu", "b": "cpu"})
    readings, ok = chip_smoke.small_readings(cfg, quant, sides["a"],
                                             sides["b"])
    assert ok, readings
    assert readings["greedy tokens equal"] == 1.0


@pytest.mark.parametrize("arch,quant", [("mixtral-8x7b", "int8"),
                                        ("xlstm-350m", "bf16")])
def test_card_breakdown_finds_nothing_between_the_cpu_and_itself(arch,
                                                                 quant):
    """The replay that finds where the card and the CPU part, with the CPU
    in the card's place: every operation it replays meets its own call's
    result (at most one bf16 step of the largest, on under 1% of the
    elements: a replay that paired calls wrongly would differ on nearly
    all; one run saw rope's results 0.085% apart on the CPU, which later
    runs did not repeat), and the check passes."""
    ops, kv, states, readings = _sensitivity().card_breakdown(
        arch, quant, device="cpu")
    assert ops and all(
        st["calls"] and st["max_over_largest"] <= 2 ** -7
        and st["share differing"] < 1e-2 for st in ops.values()), ops
    assert kv or states
    assert readings["passes"], readings
