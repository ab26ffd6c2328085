"""The whole prefill step: the window's prefill calls' model FLOPs
(`bench/counts/model.py`) over their wall seconds x 989 TFLOP/s, in %."""
from bench.counts import PEAK_BF16
from bench.counts.model import call_flops


def read(run):
    pre = [c for c in run.steps if c.kind == "prefill"]
    s = sum(c.end - c.start for c in pre)
    return 100.0 * sum(call_flops(run.cfg, c) for c in pre) / (
        s * PEAK_BF16) if s > 0 else None
