"""Admission (`serving/engine.py`): the 90th percentile of the time a
request waits in the engine's queue, from when it was due to when the
scheduler took it (`Request.admitted_time`, on the engine's clock, which
is the wall clock), over every request due in the untraced window; one
never admitted counts until the drain's end, as `ttft_p90_ms.steady`
does. Nothing to read where the program records no `admitted_time`."""
from bench.spans import queue_wait_p90_ms


def read(run):
    return queue_wait_p90_ms(run.requests, *run.window, run.t_end)
