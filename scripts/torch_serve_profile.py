"""Where the time of the PyTorch port's served steps goes, on one card.

    python3 scripts/torch_serve_profile.py [--arch llama31-8b]
        [--quant bf16] [--steps 20] [--seed 0]

Builds the full-width real-tier engine of `--arch` in `--quant` (random
weights from `--seed`), fills all 8 slots with 512-token prompts in two
prefill calls of 4, as the engine's 2048-token prefill budget admits
them, and then:
  * times prefill calls and decode steps with tracing off (host clock
    around work that ends in `torch.cuda.synchronize()`);
  * traces one prefill call and `--steps` decode steps with
    `torch.profiler`, and sums device time by kernel and by group
    (matmul, the three kernels of the port, everything else).
The device's busy share is the summed kernel time over the traced wall
time. Prints one JSON object, with every number, as its last line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def group_of(name: str) -> str:
    n = name.lower()
    if "paged_attention" in n:
        return "paged_attention"
    if "flash_attention" in n:
        return "flash_attention"
    if "int8_matmul" in n:
        return "int8_matmul"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                            "splitk")):
        return "matmul"
    return "other"


def kernel_table(prof, wall_s: float, n_calls: int):
    rows = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (t, e.count)
    total_us = sum(t for t, _ in rows.values())
    groups = {}
    for name, (t, _) in rows.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + t
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "calls": n_calls,
        "wall_ms_per_call": wall_s * 1e3 / n_calls,
        "device_ms_per_call": total_us / 1e3 / n_calls,
        "device_busy_share": total_us / 1e6 / wall_s,
        "groups_ms_per_call": {g: t / 1e3 / n_calls
                               for g, t in sorted(groups.items(),
                                                  key=lambda kv: -kv[1])},
        "top_kernels": [{"name": k[:90], "ms_per_call": t / 1e3 / n_calls,
                         "launches_per_call": c / n_calls}
                        for k, (t, c) in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31-8b")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_serve_profile: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.serve import build_engine

    eng = build_engine(args.arch, device="cuda", seed=args.seed,
                       quant=args.quant)
    ex, pm = eng.ex, eng.pm
    Bmax = eng.cfg.max_batch
    rng = np.random.default_rng(args.seed)
    tokens = np.zeros((Bmax, 512), np.int32)
    lens = np.zeros(Bmax, np.int32)
    halves = (range(0, Bmax // 2), range(Bmax // 2, Bmax))
    for half in halves:
        for _ in half:
            slot = pm.admit(512, 256)
            tokens[slot] = rng.integers(0, 1000, 512)
            lens[slot] = 512
    first = np.zeros(Bmax, np.int32)
    prefill_wall = []
    # twice: warm-up, then timed; a rerun rewrites the same pages
    for i, half in enumerate(halves * 2):
        mask = np.zeros(Bmax, bool)
        mask[list(half)] = True
        f, dt = ex.prefill(tokens, np.where(mask, lens, 0), mask,
                           pm.block_tables)
        first[mask] = f[mask]
        if i >= 2:
            prefill_wall.append(dt)
    mask = np.zeros(Bmax, bool)
    mask[list(halves[0])] = True
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.prefill(tokens, np.where(mask, lens, 0), mask, pm.block_tables)
        wall = time.perf_counter() - t0
    traced = {"prefill": kernel_table(prof, wall, 1)}

    active = np.ones(Bmax, bool)
    cur = first.copy()
    decode_wall = []
    for _ in range(5 + args.steps):         # 5 warm-up steps
        cur, dt = ex.decode(cur, active, pm.block_tables)
        decode_wall.append(dt)
    decode_wall = decode_wall[5:]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            cur, _ = ex.decode(cur, active, pm.block_tables)
        wall = time.perf_counter() - t0
    traced["decode"] = kernel_table(prof, wall, args.steps)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {
        "device": smi,
        "config": f"{args.arch}, {eng.ex.cfg.num_layers} layers, "
                  f"{args.quant}, 8 slots, page 16",
        "untraced": {
            "prefill_4x512_ms": [x * 1e3 for x in prefill_wall],
            "decode_step_b8_ms_median": statistics.median(decode_wall) * 1e3,
            "decode_step_b8_ms_p90": float(np.percentile(decode_wall, 90))
            * 1e3,
            "decode_steps": len(decode_wall),
            "context_at_first_timed_step": 512 + 5,
        },
        "traced": traced,
    }
    for phase, t in traced.items():
        print(f"{phase}: wall {t['wall_ms_per_call']:.2f} ms/call, device "
              f"{t['device_ms_per_call']:.2f} ms/call, busy "
              f"{t['device_busy_share']:.3f}; groups "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in
                          t["groups_ms_per_call"].items()))
        for k in t["top_kernels"]:
            print(f"    {k['ms_per_call']:8.4f} ms x{k['launches_per_call']:5.1f}"
                  f"  {k['name']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
