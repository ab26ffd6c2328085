"""Continuous-batching serving runtime with a paged KV cache.

The numpy scheduler (engine, paging, arrivals, metrics) is a copy of the
reference's; `RealExecutor` runs the PyTorch step functions of `runner`
on the card, with the paged- and flash-attention kernels of this package.
"""
from repro_torch.serving.arrivals import (  # noqa: F401
    ArrivalSpec, RateProfile, gamma_arrivals, poisson_arrivals,
    profile_arrivals, synth_arrays, synth_requests)
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: F401
from repro_torch.serving.executors import RealExecutor  # noqa: F401
from repro_torch.serving.metrics import MetricsRegistry  # noqa: F401
from repro_torch.serving.request import Request, RequestState  # noqa: F401
from repro_torch.serving.resilience import (  # noqa: F401
    FailureEvent, FailureSpec, FailureStream, FailureTimeline, RetryPolicy,
    as_failure_events)
