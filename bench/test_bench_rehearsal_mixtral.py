"""The CPU rehearsal of `mixtral-8x7b-int8.chat-batch`
(`bench/rehearsal.py`): the harness's whole run but the look for a card,
on a narrow model (2 layers, the full vocabulary, the config's 8 experts,
top-2, groups of 256) through the plain kernels.

- A sound run is correct at the cell's limits, and agrees with the
  reference but for a rare near-tie.
- The control, the reference in int4 at the program's tokens, reads more
  tokens far from the reference's best than a sound run does.
- The planted faults, a token altered where it is produced, one slot
  serving garbage, and half of the batch left out, come out not correct
  at the cell's own limits.
"""
import math

import pytest

from bench import faults, rehearsal

W = "mixtral-8x7b-int8.chat-batch"
VOCAB = 32000


def test_sound_run_is_correct():
    r = rehearsal.run(W, vocab=VOCAB)
    assert r["correct"], r["checks"]
    assert r["reference"]["mismatch_share"] < 0.05
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = r["metrics"]
    assert set(e2e) == {"output_tok_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in e2e.values())


def test_planted_fault_is_not_correct():
    r = rehearsal.run(W, d_model=512, vocab=VOCAB,
                      fault=faults.altered())
    assert not r["correct"]
    c = r["checks"]["slot_far_share"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("kind", faults.KINDS)
def test_slot_fault_is_not_correct(kind):
    r = rehearsal.run(W, d_model=512, vocab=VOCAB,
                      fault=faults.by_name(kind, VOCAB, 3))
    assert not r["correct"]
    c = r["checks"]["slot_far_share"]
    assert c["value"] > c["limit"], r["reference"]


def test_control_reads_far_above_a_sound_run():
    r = rehearsal.run(W, vocab=VOCAB, control="int4")
    assert r["correct"]
    assert set(r["control"]) == {"correct", "checks"}
    ref = r["reference"]
    # 2 layers on the CPU: about a quarter of int4's tokens part from the
    # reference, a sound run's all but a rare near-tie
    assert ref["control_mismatch_share"] > 0.1, ref
    assert ref["mismatch_share"] < 0.05, ref
