"""Flash attention at prefill (`kernels/flash_attention`): the sum over
the traced window's launches of each launch's least time for the
admitted prompts alone (`bench/counts/flash_attention.py`) over the
kernel's traced device time, in %. Only the prefill calls whose traced
launches are one a layer take part, on both sides of the share."""
from bench.counts import flash_attention


def read(run):
    t = run.trace
    if t is None:
        return None
    bound = dev = 0.0
    for c, (n, s) in zip(t.steps, t.per_call("flash_attention")):
        if c.kind == "prefill" and n == run.cfg.num_layers:
            bound += flash_attention.bound_s(run.cfg, c.lens[c.mask]) * n
            dev += s
    return 100.0 * bound / dev if dev else None
