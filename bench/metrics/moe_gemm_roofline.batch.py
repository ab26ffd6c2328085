"""The int8 experts' grouped GEMM (`kernels/moe_gemm`, in
`models/moe.py`): the sum over the traced window's launches of each
launch's least time (`bench/counts/moe_gemm.py`) over the kernel's
traced device time, in %. Its launches are picked by the kernel's device
symbol and binned into the call ranges as `Trace.per_call` bins a group;
only the calls whose traced launches are the ones counted take part, on
both sides of the share. A program without the kernel reads nothing."""
import bisect

from bench.counts import moe_gemm

SYMBOL = "moe_w8_gemm_kernel"


def read(run):
    t = run.trace
    if t is None or run.quant != "int8" or run.cfg.moe is None:
        return None
    starts = [r[0] for r in t.ranges]
    per_call = [[0, 0.0] for _ in t.ranges]
    for s, e, name in t.kernels:
        if SYMBOL not in name:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= t.ranges[i][1]:
            per_call[i][0] += 1
            per_call[i][1] += e - s
    bound = dev = 0.0
    for c, (n, s) in zip(t.steps, per_call):
        shapes = moe_gemm.launches(run.cfg, c, run.batch)
        if n and n == len(shapes):
            bound += sum(moe_gemm.bound_s(*x) for x in shapes)
            dev += s
    return 100.0 * bound / dev if dev else None
