"""Training entry point: train loop with checkpoint/restart, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama31-8b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu

Counterpart of `repro.launch.train`, with its flags and its log lines,
plus `--device` (default `cuda`: the card; without one it raises unless
`--device cpu`, which runs the plain versions). The loop runs under
`shardctx(make_host_mesh())`, as the reference's: a `DeviceMesh` over an
initialised process group, else the abstract (1, 1) mesh of one device,
where every sharding constraint resolves to replication.
Weights are random, drawn from `--seed` in bf16 on the device; the
optimizer's update is the fused 8-bit kernel on the card with `--opt
adamw8bit`. Restart-and-continue: re-running with the same `--ckpt-dir`
resumes from the newest intact checkpoint.

`main` returns the trained parameters, the optimizer state and each
step's `{"step", "loss", "grad_norm", "s"}`: `s` is the step's time on the
device's stream (CUDA events, read after the run) or on the host's clock
on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.parallel import shardctx
from repro_torch.serving.executors import resolve_device
from repro_torch.training import (CheckpointManager, SyntheticDataLoader,
                                  adamw, adamw8bit, build_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adamw8bit"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (reduced(args.arch, layers=args.layers, d_model=args.d_model,
                   vocab=args.vocab, ff=args.ff)
           if args.reduced else get_config(args.arch))
    with shardctx(make_host_mesh()):
        return _train(args, cfg, device)


def _train(args, cfg, device):
    opt = (adamw8bit if args.opt == "adamw8bit" else adamw)(args.lr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, device=device, generator=gen)
    opt_state = opt.init(params)
    step_fn = build_train_step(cfg, opt, remat=True)

    start = 0
    cm = None
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir, keep=3)
        res = cm.restore_latest({"params": params, "opt": opt_state},
                                device=device)
        if res is not None:
            start, tree, _ = res
            params, opt_state = tree["params"], tree["opt"]
            print(f"resumed from step {start}")

    dl = SyntheticDataLoader(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        frames=cfg.frontend_len if cfg.encoder_layers else 0,
        d_model=cfg.d_model,
        patches=16 if cfg.frontend == "vision_patches" else 0,
        device=device)

    t0 = time.time()
    tokens_done = 0
    steps = []
    for i in range(start, args.steps):
        begin = _clock(device)
        params, opt_state, stats = step_fn(params, opt_state, dl.batch_at(i))
        steps.append((i + 1, stats, begin, _clock(device)))
        tokens_done += args.batch * args.seq
        if (i + 1) % args.log_every == 0:
            loss = float(stats["loss"])
            tps = tokens_done / (time.time() - t0)
            print(f"step {i+1:5d} loss {loss:8.4f} "
                  f"gnorm {float(stats['grad_norm']):8.3f} "
                  f"tok/s {tps:9.0f}")
        if cm and (i + 1) % args.ckpt_every == 0:
            cm.save(i + 1, {"params": params, "opt": opt_state})
    if cm:
        cm.save(args.steps, {"params": params, "opt": opt_state})
        cm.wait()
    print(f"done: {args.steps - start} steps, "
          f"{time.time() - t0:.1f}s")
    history = [{"step": n, "loss": float(st["loss"]),
                "grad_norm": float(st["grad_norm"]),
                "s": _seconds(begin, end)}
               for n, st, begin, end in steps]
    return params, opt_state, history


def _clock(device):
    """Now on `device`'s stream: a recorded CUDA event, or the host's
    clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _seconds(begin, end) -> float:
    if isinstance(begin, float):
        return end - begin
    end.synchronize()
    return begin.elapsed_time(end) / 1e3


if __name__ == "__main__":
    main()
