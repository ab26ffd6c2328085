"""Scheduler host time (`serving/engine.py`): the mean wall ms from an
executor call's return to the next call's start, in the window, less any
sleep to an arrival."""


def read(run):
    s = run.steps
    gaps = [(b.start - a.end - b.slept) for a, b in zip(s, s[1:])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
