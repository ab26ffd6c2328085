"""Continuous-batching serving runtime with a paged KV cache.

The numpy scheduler (engine, paging, arrivals, metrics) is a copy of the
reference's. Two execution tiers share it:
  * RealExecutor — the PyTorch step functions of `runner` on the card,
    with the kernels of this package; wall-clock step timing.
  * SimExecutor  — the calibrated step-time model of `simulate` (the
    reference's TPUs and the H100); virtual-clock timing, no device.

`fleet` is the third scheduler path: a struct-of-arrays simulator that
runs B independent sim-tier cells as lanes of one vectorized numpy event
loop, bit-identical to the scalar fast-forward engine; `fleet_jit` runs
the same loop as one CUDA kernel (`kernels.fleet_loop`). Importing this
package loads neither torch nor the runner.
"""
from repro_torch.serving.arrivals import (  # noqa: F401
    ArrivalSpec, RateProfile, gamma_arrivals, poisson_arrivals,
    profile_arrivals, synth_arrays, synth_requests)
from repro_torch.serving.autoscale import (  # noqa: F401
    DAY_SCENARIOS, AutoscalePolicy, DayScenario, Deployment, FleetWindow,
    meter_day_report, price_day, simulate_policy, static_size,
    static_windows)
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: F401
from repro_torch.serving.executors import (  # noqa: F401
    RealExecutor, SimExecutor)
from repro_torch.serving.fleet import (  # noqa: F401
    FleetEngine, FleetPoint, FleetStepModel, fleet_run_points)
from repro_torch.serving.metrics import MetricsRegistry  # noqa: F401
from repro_torch.serving.request import Request, RequestState  # noqa: F401
from repro_torch.serving.resilience import (  # noqa: F401
    FailureEvent, FailureSpec, FailureStream, FailureTimeline, RetryPolicy,
    as_failure_events)
