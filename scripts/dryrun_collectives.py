"""Where a dry-run cell's collectives come from: run one cell of
`repro_torch.launch.dryrun` and print its collective operand bytes a
device by kind and by the two innermost lines of the port that issued
them (the model's op and its caller), largest first, with the count of
calls. The totals equal the cell's record (`collective_bytes`).

    PYTHONPATH=src python scripts/dryrun_collectives.py --arch whisper-base \\
        --shape decode_32k [--multi-pod] [--flash-decode]

Imports no JAX. DTensor picks its resharding by the torch version, so
the bytes differ between versions; the last line is all of it as JSON,
with the torch version.
"""
import argparse
import collections
import json
import traceback

import torch

import repro_torch.launch.dryrun as dryrun
import repro_torch.models.model as model_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--flash-decode", action="store_true")
    args = ap.parse_args(argv)
    by_source = collections.Counter()
    calls = collections.Counter()
    dispatch = dryrun.OpCounter.__torch_dispatch__

    def traced(self, func, types, a=(), kw=None):
        before = dict(self.collectives)
        out = dispatch(self, func, types, a, kw)
        for kind, n in self.collectives.items():
            if n != before[kind]:
                lines = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                         for f in traceback.extract_stack()
                         if "repro_torch" in f.filename
                         and "launch/dryrun" not in f.filename]
                key = (kind, " < ".join(reversed(lines[-2:])))
                by_source[key] += n - before[kind]
                calls[key] += 1
        return out

    dryrun.OpCounter.__torch_dispatch__ = traced
    model_lib.PERF = model_lib.PerfConfig(flash_decode=args.flash_decode)
    rec = dryrun.run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                          save=False, verbose=False)
    rows = [{"kind": k, "source": src, "bytes": int(b),
             "calls": calls[(k, src)]}
            for (k, src), b in by_source.most_common()]
    for r in rows:
        print(f"{r['bytes']:>14,} B {r['calls']:>5} calls  {r['kind']:<18} "
              f"{r['source']}")
    assert sum(r["bytes"] for r in rows) == rec["collective_bytes"]["total"]
    print(json.dumps({"cell": f"{args.arch} x {args.shape} x {rec['mesh']}",
                      "torch": torch.__version__,
                      "collective_bytes": rec["collective_bytes"],
                      "by_source": rows}))


if __name__ == "__main__":
    main()
