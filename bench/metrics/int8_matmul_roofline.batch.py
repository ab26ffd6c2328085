"""The int8 GEMM (`kernels/int8_matmul`): the sum over the traced
window's launches of each launch's least time
(`bench/counts/int8_matmul.py`) over the kernel's traced device time, in
%. Only the calls whose traced launches are the ones counted take part,
on both sides of the share."""
from bench.counts import int8_matmul


def read(run):
    t = run.trace
    if t is None or run.quant != "int8":
        return None
    bound = dev = 0.0
    for c, (n, s) in zip(t.steps, t.per_call("int8_matmul")):
        shapes = int8_matmul.launches(run.cfg, c, run.batch)
        if n == len(shapes):
            bound += sum(int8_matmul.bound_s(*x) for x in shapes)
            dev += s
    return 100.0 * bound / dev if dev else None
