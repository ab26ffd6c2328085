"""The whole step: the window's model FLOPs (`bench/counts/model.py`)
over the window's wall seconds x 989 TFLOP/s (bf16 dense), in %."""
from bench.counts import PEAK_BF16
from bench.counts.model import call_flops


def read(run):
    w = run.window[1] - run.window[0]
    flops = sum(call_flops(run.cfg, c) for c in run.steps)
    return 100.0 * flops / (w * PEAK_BF16) if w > 0 else None
