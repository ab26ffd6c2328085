"""Beyond-paper optimized sweep: apply the §Perf winners fleet-wide.

Counterpart of `repro.launch.optimized_sweep`. The (arch x shape) grid
comes from the experiment subsystem's shared grid walker
(`repro_torch.experiments.iter_grid`) and the PERF overrides are applied
as a *plan transform*: `perf_variant(cfg)` maps a baseline cell to its
optimized twin, and the sweep runs the transformed grid.

Serving cells (decode/prefill): fp8-e4m3 KV cache + flash-decoding.
Recurrent-arch cells (ssm/hybrid): + local recurrence on the batch shard.
Baselines are the port's dry-run records (examples_out/dryrun/, written
by `launch.dryrun`); results go to examples_out/dryrun_opt/<cell>.json;
prints baseline-vs-optimized frac.

    PYTHONPATH=src python -m repro_torch.launch.optimized_sweep [--shapes decode_32k,long_500k]
"""
from __future__ import annotations

import argparse
import contextlib
import json

import torch

import repro_torch.models.model as model_lib
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.experiments.plan import iter_grid
from repro_torch.launch.dryrun import RESULTS, run_cell

OPT_RESULTS = RESULTS.parent / "dryrun_opt"


def perf_variant(cfg) -> "model_lib.PerfConfig":
    """The transform: baseline cell -> §Perf-winner overrides for it."""
    return model_lib.PerfConfig(
        kv_cache_dtype=torch.float8_e4m3fn,
        flash_decode=True,
        local_recurrence=cfg.family in ("ssm", "hybrid"))


@contextlib.contextmanager
def perf_overrides(perf: "model_lib.PerfConfig"):
    prev = model_lib.PERF
    model_lib.PERF = perf
    try:
        yield
    finally:
        model_lib.PERF = prev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="decode_32k,long_500k")
    ap.add_argument("--archs", default=",".join(ALL_ARCHS))
    args = ap.parse_args(argv)
    shapes = args.shapes.split(",")
    OPT_RESULTS.mkdir(parents=True, exist_ok=True)

    rows = []
    for ax in iter_grid(arch=args.archs.split(","), shape=shapes):
        arch, shape = ax["arch"], ax["shape"]
        cfg = get_config(arch)
        if shape not in {s.name for s in cfg.shapes()}:
            continue
        base_f = RESULTS / f"{arch}_{shape}_16x16_bf16.json"
        base = json.load(open(base_f)) if base_f.exists() else None
        try:
            with perf_overrides(perf_variant(cfg)):
                rec = run_cell(arch, shape, save=False, verbose=False)
        except Exception as e:  # noqa: BLE001
            print(f"FAIL {arch} x {shape}: {e}")
            continue
        (OPT_RESULTS / f"{arch}_{shape}_16x16_bf16.json").write_text(
            json.dumps(rec, indent=1))
        t = rec["roofline"]
        b = base["roofline"] if base else {}
        rows.append((arch, shape, b.get("roofline_frac"),
                     t["roofline_frac"], b.get("memory_s"),
                     t["memory_s"], b.get("collective_s"),
                     t["collective_s"]))
        print(f"{arch:<26} {shape:<11} frac "
              f"{b.get('roofline_frac', float('nan')):.3f}"
              f"->{t['roofline_frac']:.3f}  mem "
              f"{b.get('memory_s', float('nan')):.4g}"
              f"->{t['memory_s']:.4g}  coll "
              f"{b.get('collective_s', float('nan')):.4g}"
              f"->{t['collective_s']:.4g}")
    better = sum(1 for r in rows if r[2] is not None and r[3] > r[2])
    print(f"\n{better}/{len(rows)} cells improved roofline fraction")


if __name__ == "__main__":
    main()
