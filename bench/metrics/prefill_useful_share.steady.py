"""Admission and padding (`serving/engine.py`): the share of a prefill
call's (max_batch x Lp) rows that are admitted prompt tokens, over the
window's prefill calls, in %."""


def read(run):
    pre = [c for c in run.steps if c.kind == "prefill"]
    rows = sum(c.tokens.size for c in pre)
    return 100.0 * sum(int(c.lens[c.mask].sum()) for c in pre) / rows \
        if rows else None
