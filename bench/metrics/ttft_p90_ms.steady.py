"""Admission and queueing (`serving/engine.py`): the 90th percentile of
the time to first token, from when each request was due to the wall
stamp of its first token, over every request due in the untraced
window; one never served counts until the drain's end. Not an
end-to-end metric: with fixed 755-token prompts and two admitted a
prefill call, TTFT comes in steps of one prefill call, and its 90th
percentile jumps between them from run to run."""
import numpy as np


def read(run):
    w0, w1 = run.window
    due = [r for r in run.requests if w0 <= r.arrival_time < w1]
    if not due:
        return None
    ttft = [(run.stamps[r.rid][0] if r.rid in run.stamps else run.t_end)
            - r.arrival_time for r in due]
    return 1e3 * float(np.percentile(ttft, 90))
