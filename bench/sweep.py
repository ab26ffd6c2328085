#!/usr/bin/env python3
"""Find the knee of an open-loop cell: serve its mix at several fixed
rates on one engine, on the wall clock, and print for each rate what the
window completed and how the queue and TTFT grew. The cell's rate is then
fixed in its traffic file; the benchmark itself never searches for one.

    python3 bench/sweep.py --workload nemotron-4-15b-bf16.coding-steady \
        --rates 1,1.5,2,2.5,3,4 --seconds 20 --seed 5
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from bench import clock as clock_lib, manifest as mf, run, traffic
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CARD_ENGINE
    from repro_torch.serving import Engine, EngineConfig
    run.caches()
    if not torch.cuda.is_available():
        sys.exit("sweep: needs a CUDA device")
    device = torch.device("cuda")
    manifest = mf.load_manifest()
    cell = mf.cell(manifest, args.workload)
    cfile = mf.load_config_file(manifest, cell["config"])
    mix = mf.load_traffic(cell["traffic"])
    cfg = mf.model_config(cfile, get_config(cfile["arch"]))
    ecfg = dict(CARD_ENGINE)
    ex = run.build_program(cfg, cfile["quant"], args.seed, device, ecfg,
                           mix)
    for rate in [float(r) for r in args.rates.split(",")]:
        m = dict(mix, arrivals=dict(mix["arrivals"], rate=rate))
        for pool in ex.pools:
            for t in pool.values():
                t.zero_()
        ex.seq_lens.zero_()
        eng = Engine(EngineConfig(**ecfg), ex)
        reqs = traffic.requests(m, args.seconds, args.seed, cfg.vocab_size)
        clock = clock_lib.WallClock(eng)
        clock.start()
        eng.run(reqs, horizon=m["warm_s"])
        w0 = eng.t
        eng.run(reqs, horizon=w0 + args.seconds)
        w1 = eng.t
        clock.detach()
        due = [r for r in reqs if w0 <= r.arrival_time < w1]
        ttft = [(clock.stamps[r.rid][0] if r.rid in clock.stamps else w1)
                - r.arrival_time for r in due]
        done = [r for r in reqs if r.finish_time is not None
                and w0 <= r.finish_time <= w1]
        waiting = [r for r in due if r.rid not in clock.stamps]
        steps = [c for c in clock.calls if c.kind != "reset"
                 and c.start >= w0]
        pre = [c for c in steps if c.kind == "prefill"]
        print(json.dumps({
            "rate": rate, "due": len(due), "window_s": w1 - w0,
            "completed_per_s": len(done) / (w1 - w0),
            "waiting_at_end": len(waiting),
            "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
            "ttft_p90_ms": 1e3 * float(np.percentile(ttft, 90)),
            "prefill_calls": len(pre),
            "prefill_ms": 1e3 * float(np.mean([c.end - c.start
                                               for c in pre])),
            "decode_steps": len(steps) - len(pre)}), flush=True)
    print(f"card: {run.power_limit()}")


if __name__ == "__main__":
    main()
