"""Lambda-sweep orchestration (paper §4.3 protocol).

For each offered rate on the ladder: warmup requests (discarded), then a
measured run; when the server is queue-limited the statistics use
completed-requests-within-window, exactly as the paper does at lambda>=50.
The sweep emits RunRecords; theta_max is back-filled as the max measured
TPS across the ladder (raw saturation, no SLO bound — §4.4).

Two drivers share the same per-point protocol; both are thin ladder
plans over the experiment-matrix subsystem (`repro_torch.experiments`):

* `lambda_sweep`  — serial, any engine factory.
* `parallel_sweep` — independent (lambda, config) points fanned across a
  `concurrent.futures` process pool. Per-point seeds are derived exactly
  as in the serial path (`seed + int(lam * 1000)`), so the two drivers
  return identical records in ladder order. The engine factory must be
  picklable (use `SimEngineSpec`); if the pool cannot be used (factory
  not picklable, pool start failure) the sweep falls back to the serial
  path with a `RuntimeWarning` naming the reason — results are the same
  either way, just single-core.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.cost import c_eff
from repro_torch.core.records import RunRecord
from repro_torch.serving.arrivals import ArrivalSpec, synth_requests
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.overload import OverloadPolicy

# The paper's 7-point ladder.
LAMBDA_LADDER = (1, 5, 10, 25, 50, 100, 200)


# paper §5.8: prompts = 60*lam clamped [500,6000]; module-level (not
# lambdas) so the defaults survive pickling into pool workers.
def default_requests_per_point(lam: float) -> int:
    return int(min(6000, max(500, 60 * lam)))


def default_warmup_per_point(lam: float) -> int:
    return int(max(100, 30 * lam) // 10)


@dataclasses.dataclass(frozen=True)
class SimEngineSpec:
    """Picklable sim-tier engine factory (the unit parallel_sweep ships to
    pool workers; also handy anywhere a closure-free factory is needed)."""
    arch: str
    hw: str = "tpu-v5e"
    quant: str = "bf16"
    n_chips: int = 1
    max_batch: int = 128
    page_size: int = 16
    num_pages: int = 32768
    max_pages_per_seq: int = 64
    prefill_token_budget: int = 2048
    max_prefill_reqs: int = 8
    fast_forward: bool = True
    max_queue_depth: int = 0            # >0: admission-control shedding
    deadline_s: float = 0.0             # >0: queue-time deadline
    overload: Optional[OverloadPolicy] = None     # overload controller

    def __call__(self) -> Engine:
        from repro_torch.configs import get_config
        from repro_torch.serving.executors import SimExecutor
        from repro_torch.simulate import HW_BY_NAME, StepTimeModel
        cfg = get_config(self.arch)
        stm = StepTimeModel(cfg, HW_BY_NAME[self.hw], n_chips=self.n_chips,
                            quant=self.quant)
        ecfg = EngineConfig(
            max_batch=self.max_batch, page_size=self.page_size,
            num_pages=self.num_pages,
            max_pages_per_seq=self.max_pages_per_seq,
            prefill_token_budget=self.prefill_token_budget,
            max_prefill_reqs=self.max_prefill_reqs,
            fast_forward=self.fast_forward,
            max_queue_depth=self.max_queue_depth,
            deadline_s=self.deadline_s,
            overload=self.overload)
        return Engine(ecfg, SimExecutor(cfg, stm))


def _pct(vals, q):
    vals = [v for v in vals if v is not None]
    return float(np.percentile(vals, q)) * 1e3 if vals else float("nan")


def run_point(engine_factory: Callable[[], Engine], spec: ArrivalSpec, *,
              warmup: int = 0, horizon: Optional[float] = None,
              config: str = "", model: str = "", hw: str = "cpu-node",
              n_chips: int = 1, quant: str = "bf16", engine_kind: str = "sim",
              price_per_hr: float = 1.0,
              failure_times: Sequence[float] = (),
              failure_spec=None, retry=None) -> RunRecord:
    """One (lambda, config) measurement."""
    eng = engine_factory()
    if warmup:
        wspec = dataclasses.replace(spec, n_requests=warmup,
                                    seed=spec.seed + 7777)
        eng.run(synth_requests(wspec))
        # reset clock + metrics (gauges included), keep compiled state warm
        eng.reset_measurement()

    reqs = synth_requests(spec)
    eng.run(reqs, horizon=horizon, failure_times=failure_times,
            failure_spec=failure_spec, retry=retry)
    done = [r for r in reqs if r.finish_time is not None]
    window = eng.t
    out_toks = sum(r.tokens_out for r in done)
    in_toks = sum(r.prompt_len for r in done)
    tps = out_toks / window if window > 0 else 0.0
    m = eng.metrics
    rec = RunRecord(
        config=config, model=model, hw=hw, n_chips=n_chips, quant=quant,
        engine=engine_kind, lam=spec.lam, io_shape=spec.io_shape,
        n_requests=spec.n_requests, n_completed=len(done), window_s=window,
        tps=tps, prompt_tps=in_toks / window if window else 0.0,
        ttft_p50_ms=_pct([r.ttft for r in done], 50),
        ttft_p90_ms=_pct([r.ttft for r in done], 90),
        ttft_p99_ms=_pct([r.ttft for r in done], 99),
        tpot_p50_ms=_pct([r.tpot for r in done], 50),
        tpot_p99_ms=_pct([r.tpot for r in done], 99),
        e2e_p50_ms=_pct([r.e2e for r in done], 50),
        e2e_p99_ms=_pct([r.e2e for r in done], 99),
        mean_inflight=eng.mean_inflight(),
        price_per_hr=price_per_hr,
        c_eff=c_eff(price_per_hr, tps),
        seed=spec.seed,
        mttf=failure_spec.mttf if failure_spec is not None else 0.0,
        retry_max=retry.max_attempts if retry is not None else 0,
        n_shed=int(m.get("repro:request_shed_total")),
        n_timeout=int(m.get("repro:request_timeout_total")),
        n_retried=int(m.get("repro:request_retry_total")),
        n_abandoned=int(m.get("repro:request_abandoned_total")),
        n_class_shed=int(m.get("repro:request_class_shed_total")),
        n_browned=int(m.get("repro:request_browned_total")),
        browned_tokens=int(m.get("repro:browned_tokens_total")),
        n_slo_viol=int(m.get("repro:request_slo_violation_total")),
        # gated on class_mix so classless cells
        # keep the 0.0 default byte-for-byte
        interactive_tps=(sum(r.tokens_out for r in done if r.priority == 0)
                         / window if (spec.class_mix and window > 0)
                         else 0.0))
    return rec


def _ladder_sweep(engine_factory, *, parallel, ladder, io_shape, scale,
                  requests_per_point, warmup_per_point, horizon, seed,
                  process, cv, max_workers=None, mp_context=None,
                  backend="process", **record_kw) -> List[RunRecord]:
    """Both drivers: build the single-group ladder plan (seeds
    `seed + int(lam * 1000)`, the ladder's own rule) and hand it to the
    experiment runner. Imported lazily — `repro_torch.experiments` depends on
    this module at import time, not vice versa."""
    from repro_torch.experiments.plan import ladder_plan
    from repro_torch.experiments.runner import PlanRunner
    plan = ladder_plan(ladder=ladder, io_shape=io_shape, scale=scale,
                       requests_per_point=requests_per_point,
                       warmup_per_point=warmup_per_point, horizon=horizon,
                       seed=seed, process=process, cv=cv, **record_kw)
    return PlanRunner(plan, factory=engine_factory).run(
        parallel=parallel, max_workers=max_workers, mp_context=mp_context,
        backend=backend)


def lambda_sweep(engine_factory, *, ladder: Sequence[float] = LAMBDA_LADDER,
                 io_shape: str = "chat", scale: float = 1.0,
                 requests_per_point: Callable[[float], int] = None,
                 warmup_per_point: Callable[[float], int] = None,
                 horizon: Optional[float] = None, seed: int = 0,
                 process: str = "poisson", cv: float = 1.0,
                 **record_kw) -> List[RunRecord]:
    """Full ladder sweep; back-fills theta_max = max TPS across points."""
    return _ladder_sweep(engine_factory, parallel=False, ladder=ladder,
                         io_shape=io_shape, scale=scale,
                         requests_per_point=requests_per_point,
                         warmup_per_point=warmup_per_point, horizon=horizon,
                         seed=seed, process=process, cv=cv, **record_kw)


def parallel_sweep(engine_factory, *,
                   ladder: Sequence[float] = LAMBDA_LADDER,
                   io_shape: str = "chat", scale: float = 1.0,
                   requests_per_point: Callable[[float], int] = None,
                   warmup_per_point: Callable[[float], int] = None,
                   horizon: Optional[float] = None, seed: int = 0,
                   process: str = "poisson", cv: float = 1.0,
                   max_workers: Optional[int] = None,
                   mp_context: Optional[str] = None,
                   backend: str = "process",
                   **record_kw) -> List[RunRecord]:
    """`lambda_sweep` with independent ladder points fanned across a
    process pool; records come back in ladder order with identical values
    (same deterministic per-point seeds, same per-point protocol).
    `backend="vector"` runs SimEngineSpec ladders through the fleet
    simulator instead — same records, lanes x cores; `backend="jit"`
    through the fleet-loop kernel on the card (`experiments.runner`).

    Start method (`mp_context=None`): `fork` when torch has not been
    imported into this process (sim-tier parents stay torch-free because
    the executors import it lazily) — workers then start in
    milliseconds; otherwise `spawn`, which avoids forking a parent that
    may hold live torch or CUDA threads at the cost of ~1s interpreter+numpy
    startup per worker. Pool overhead only amortizes for paper-scale
    points; tiny ladders are often faster through `lambda_sweep`.

    If the pool cannot be used (unpicklable factory, pool start failure)
    the sweep emits a `RuntimeWarning` naming the reason and degrades to
    the serial path with identical results.
    """
    return _ladder_sweep(engine_factory, parallel=True, ladder=ladder,
                         io_shape=io_shape, scale=scale,
                         requests_per_point=requests_per_point,
                         warmup_per_point=warmup_per_point, horizon=horizon,
                         seed=seed, process=process, cv=cv,
                         max_workers=max_workers, mp_context=mp_context,
                         backend=backend, **record_kw)
