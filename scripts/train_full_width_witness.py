"""Where the full-width training run's loss curve comes from: the port on
the card against its plain version on the CPU, at llama31-8b's full width.

    PYTHONPATH=src python3 scripts/train_full_width_witness.py \\
        [--layers 2] [--lr 1e-4] [--steps 4] [--deep-lrs 1e-4,3e-5,1e-5]

(1) At full depth, through `repro_torch.launch.train.main` on the card
(the flags of `chip_smoke.py`'s phase 9b but the rate): the losses at each
rate of `--deep-lrs`.
(2) llama31-8b at full width cut to `--layers` layers, bf16 weights drawn
on the CPU from seed 0, `--steps` steps of phase 9b's batches (2 x 512
synthetic tokens, seed 0) at `--lr`: adamw8bit on the card (the fused
kernel), adamw on the card (fp32 moments: no 8-bit codec), and adamw8bit
on the CPU (the kernel's plain version, which the CPU tests hold to the
jitted reference's update). After each adamw8bit step it reads the share
of elements whose v code is 0 while their m code is not (there the
update's denominator is only this step's gradient).
Each curve is printed as it ends and written to
`chiprun_out/train_full_width_witness.json`; the last line is the JSON of
every curve with the card's name and power limit. Needs a card; imports
no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "train_full_width_witness.json")
DEEP = ["--arch", "llama31-8b", "--opt", "adamw8bit", "--steps", "4",
        "--batch", "2", "--seq", "512", "--log-every", "1", "--seed", "0"]


def v_zero_share(state) -> float:
    """Share of elements whose v code is 0 and m code is not."""
    from repro_torch.training.optimizer import tree_leaves
    ms = [t for t in tree_leaves(state["m"]) if t.dtype == torch.int8]
    vs = [t for t in tree_leaves(state["v"]) if t.dtype == torch.int8]
    n = sum(t.numel() for t in ms)
    return sum(int(((v == 0) & (m != 0)).sum()) for m, v in zip(ms, vs)) / n


def cut_run(params_cpu, cfg, opt_name, lr, steps, device) -> dict:
    """`steps` train steps of `cfg` from a copy of `params_cpu` on
    `device`; each step's loss, grad norm, seconds and (adamw8bit) the v
    codes' zero share."""
    from repro_torch.training import (SyntheticDataLoader, adamw, adamw8bit,
                                      build_train_step)
    from repro_torch.training.optimizer import tree_map
    params = tree_map(lambda t: t.to(device, copy=True), params_cpu)
    opt = (adamw8bit if opt_name == "adamw8bit" else adamw)(lr)
    state = opt.init(params)
    step = build_train_step(cfg, opt, remat=True)
    dl = SyntheticDataLoader(cfg.vocab_size, 2, 512, seed=0, device=device)
    out = {"opt": opt_name, "device": device, "lr": lr, "loss": [],
           "grad_norm": [], "s": [], "v_zero_share": []}
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, st = step(params, state, dl.batch_at(i))
        out["loss"].append(float(st["loss"]))
        out["grad_norm"].append(float(st["grad_norm"]))
        out["s"].append(time.perf_counter() - t0)
        if opt_name == "adamw8bit":
            out["v_zero_share"].append(v_zero_share(state))
        print(f"  {opt_name} {device} lr {lr} step {i + 1}: loss "
              f"{out['loss'][-1]} gnorm {out['grad_norm'][-1]} "
              f"{out['s'][-1]:.1f} s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--deep-lrs", default="1e-4,3e-5,1e-5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("train_full_width_witness: needs a CUDA device")
    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "deep": [], "cut": []}

    def save():
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "w") as f:
            json.dump(result, f)

    for lr in [float(x) for x in args.deep_lrs.split(",") if x]:
        hist = train_mod.main(DEEP + ["--lr", str(lr)])[2]
        result["deep"].append({"lr": lr, "layers": 32, "steps": hist})
        print(f"32 layers lr {lr}: losses {[h['loss'] for h in hist]}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        save()

    cfg = dataclasses.replace(get_config("llama31-8b"),
                              num_layers=args.layers)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    for opt_name, device in (("adamw8bit", "cuda"), ("adamw", "cuda"),
                             ("adamw8bit", "cpu")):
        run = cut_run(params, cfg, opt_name, args.lr, args.steps, device)
        run["layers"] = args.layers
        result["cut"].append(run)
        print(f"{args.layers} layers {opt_name} {device}: losses "
              f"{run['loss']}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        save()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
