"""Paged decode attention (`kernels/paged_attention`): the sum over the
traced window's launches of each launch's least time
(`bench/counts/paged_attention.py`) over the kernel's traced device
time, in %. Only the decode calls whose traced launches are one a layer
take part, on both sides of the share."""
from bench.counts import paged_attention


def read(run):
    t = run.trace
    if t is None:
        return None
    bound = dev = 0.0
    for c, (n, s) in zip(t.steps, t.per_call("paged_attention")):
        if c.kind == "decode" and n == run.cfg.num_layers:
            bound += paged_attention.bound_s(
                run.cfg, c.context + c.mask) * n
            dev += s
    return 100.0 * bound / dev if dev else None
