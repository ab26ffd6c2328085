"""The model step (`serving/executors.py` + `serving/runner.py`): the
window's decode-call wall ms over its decode steps."""


def read(run):
    d = [c.end - c.start for c in run.steps if c.kind == "decode"]
    return 1e3 * sum(d) / len(d) if d else None
