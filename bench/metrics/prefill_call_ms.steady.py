"""The model step (`serving/executors.py` + `serving/runner.py`): the
window's prefill-call wall ms over its prefill calls."""


def read(run):
    d = [c.end - c.start for c in run.steps if c.kind == "prefill"]
    return 1e3 * sum(d) / len(d) if d else None
