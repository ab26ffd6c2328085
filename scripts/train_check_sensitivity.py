"""How far the card's rounding and planted faults move `chip_smoke.py`'s
training small check (phase 9a): the yardstick for its bounds.

    PYTHONPATH=src python3 scripts/train_check_sensitivity.py [--seeds 8]
        [--lr 1e-3]

For each weight seed 1..N:
- free-running: `chip_smoke.train_small_run` (the narrow llama31-8b,
  adamw8bit, `TRAIN_SMALL`'s steps) on the CPU, on the card, and on the
  card with the clip skipped (the planted fault), then
  `chip_smoke.train_small_readings` of card against CPU (sound) and of the
  faulted card run against the CPU;
- step by step: `chip_smoke.train_lockstep_run` sound and with each of
  `chip_smoke.TRAIN_FAULTS` planted on the card's side.
Prints each seed's readings and, as its last line, JSON with the largest
sound reading and the smallest fault reading of each, and their geometric
mean: where the small checks set their bounds. A step-by-step reading is
set against the faults that move it (`SEEN_BY`): the kernel's unencoded
block leaves every parameter as it should be, so only the codes see it.
`--lr` replaces `TRAIN_SMALL`'s rate (the check's own is 1e-3; at 3e-3
adamw8bit diverges on this model). Needs a card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the planted faults each step-by-step reading is held against
SEEN_BY = {"params off": ("clip skipped",),
           "codes off": ("clip skipped", "block left unencoded")}


def spread(sound, faults) -> dict:
    """The farthest sound reading, the nearest fault reading and their
    geometric mean, for each key of the sound readings."""
    out = {}
    for k in sound[0]:
        hi, lo = max(r[k] for r in sound), min(r[k] for r in faults)
        out[k] = {"farthest sound": hi, "nearest fault": lo,
                  "geometric mean": math.sqrt(hi * lo) if hi > 0 else None}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("train_check_sensitivity: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.serving.runner import set_matmul_precision
    set_matmul_precision()
    if args.lr is not None:
        chip_smoke.TRAIN_SMALL["lr"] = args.lr
    sound, fault = [], []
    lock = {f: [] for f in ("sound",) + chip_smoke.TRAIN_FAULTS}
    for seed in range(1, args.seeds + 1):
        cpu = chip_smoke.train_small_run("cpu", seed)
        card = chip_smoke.train_small_run("cuda", seed)
        faulty = chip_smoke.train_small_run("cuda", seed, grad_clip=None)
        sound.append(chip_smoke.train_small_readings(cpu, card))
        fault.append(chip_smoke.train_small_readings(cpu, faulty))
        for f in lock:
            lock[f].append(chip_smoke.train_lockstep_run(
                seed, None if f == "sound" else f))
        print(f"seed {seed}: losses cpu {cpu[0]}, card {card[0]}, card "
              f"without clip {faulty[0]}; sound {sound[-1]}; fault "
              f"{fault[-1]}; step by step "
              f"{json.dumps({f: r[-1] for f, r in lock.items()})}",
              flush=True)
    out = spread(sound, fault)
    out["step by step"] = {
        k: spread([{k: r[k]} for r in lock["sound"]],
                  [{k: r[k]} for f in SEEN_BY[k] for r in lock[f]])[k]
        for k in SEEN_BY}
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
