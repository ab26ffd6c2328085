"""The port's numpy fleet, its vector backend and autoscale against the
reference's.

All numpy on both sides, so exact equality (records compared field by
field through `repr`, so a NaN matches a NaN and 1e-16 of drift does not):
(a) `fleet_run_points` records on the mini plans, failure injection
    (single and stacked), ragged lanes and the warmup protocol, and the
    bitwise `FleetStepModel` mirror;
(b) within the port, the vector backend's records equal the process
    backend's, serial and pooled (work-stealing chunks);
(c) the vector backend's store files, byte for byte, and
    `parallel_sweep(backend="vector")`;
(d) `serving.autoscale`: `simulate_policy`, `price_day`, the SLO-aware
    head-to-head and the day scenarios' trajectories and rate ladders.
"""
import dataclasses
import math

import numpy as np
import pytest

import repro.core as jcore
import repro.experiments as jexp
import repro.serving.autoscale as jauto
import repro_torch.core as tcore
import repro_torch.experiments as texp
import repro_torch.serving.autoscale as tauto
from repro.experiments import plan as jplan
from repro.serving import fleet as jfleet
from repro_torch.experiments import plan as tplan
from repro_torch.serving import fleet as tfleet


def _points(fleet, cells, factory=None):
    return [fleet.FleetPoint(engine=factory or c.engine_spec(),
                             arrivals=c.arrival_spec(), warmup=c.warmup,
                             horizon=c.horizon, failure_times=c.failure_times,
                             failure_spec=c.failure_spec(),
                             retry=c.retry_policy(), **c.record_kw())
            for c in cells]


def _assert_records_equal(xs, ys, ctx=""):
    assert len(xs) == len(ys) > 0
    for a, b in zip(xs, ys):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for key in da:
            assert repr(da[key]) == repr(db[key]), \
                (ctx, a.model, a.hw, a.quant, a.lam, key, da[key], db[key])


BIG = dict(max_pages_per_seq=512, num_pages=131072)


def _cells(exp, plan, case):
    """The cells of one case, built by one side's own package."""
    if case in ("mini_2x2", "mini_crosshw", "mini_ensemble"):
        return list(exp.get_plan(case).cells)
    if case == "failures":
        return list(plan.ladder_plan(
            ladder=(5, 20), failure_times=[0.5, 1.5, 3.0],
            arch="llama31-8b", config="C1", model="llama31-8b",
            hw="tpu-v5e").cells)
    if case == "stacked_failures":
        cells = []
        for ft in [(0.5, 0.502, 0.504, 0.506), (1.0, 1.001)]:
            p = plan.ladder_plan(ladder=(80,), io_shape="variable",
                                 process="gamma", cv=2.0, failure_times=ft,
                                 arch="qwen3-30b-a3b", model="qwen3-30b-a3b",
                                 hw="tpu-v5p")
            cells += [dataclasses.replace(c, max_prefill_reqs=1, **BIG)
                      for c in p.cells]
        return cells
    if case == "ragged":
        cells = list(plan.ladder_plan(
            ladder=(1, 80), arch="llama31-8b", model="llama31-8b",
            hw="tpu-v5e", requests_per_point=lambda lam: 120,
            warmup_per_point=lambda lam: 15).cells)
        cells += [dataclasses.replace(c, **BIG) for c in plan.ladder_plan(
            ladder=(10,), io_shape="variable", process="gamma", cv=2.0,
            arch="qwen3-30b-a3b", model="qwen3-30b-a3b",
            hw="tpu-v5p").cells]
        cells += list(plan.ladder_plan(
            ladder=(10, 50), horizon=4.0, arch="mixtral-8x7b",
            model="mixtral-8x7b", hw="tpu-v5e", n_chips=2).cells)
        cells += list(plan.ladder_plan(
            ladder=(15,), failure_times=[0.3, 2.0], arch="llama31-8b",
            model="llama31-8b", hw="tpu-v5e").cells)
        return cells
    if case == "resilient":
        return list(exp.get_plan("mini_resilience").cells)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["mini_2x2", "mini_crosshw", "failures",
                                  "stacked_failures", "ragged", "resilient"])
def test_fleet_records_match_reference(case):
    ref = jfleet.fleet_run_points(_points(jfleet, _cells(jexp, jplan, case)))
    port = tfleet.fleet_run_points(_points(tfleet,
                                           _cells(texp, tplan, case)))
    _assert_records_equal(ref, port, case)


def test_fleet_warmup_protocol_matches_reference():
    kw = dict(ladder=(5, 25), arch="llama31-8b", model="llama31-8b",
              hw="tpu-v5e", requests_per_point=lambda lam: 150,
              warmup_per_point=lambda lam: 25)
    ref = jfleet.fleet_run_points(_points(
        jfleet, jplan.ladder_plan(**kw).cells,
        factory=jcore.SimEngineSpec("llama31-8b", max_batch=64,
                                    num_pages=8192)))
    port = tfleet.fleet_run_points(_points(
        tfleet, tplan.ladder_plan(**kw).cells,
        factory=tcore.SimEngineSpec("llama31-8b", max_batch=64,
                                    num_pages=8192)))
    _assert_records_equal(ref, port, "warmup")
    assert all(r.n_completed == r.n_requests for r in port)


def test_fleet_step_model_matches_reference_bitwise():
    from repro.configs import get_config as jget
    from repro.simulate import HW_BY_NAME as JHW, StepTimeModel as JSTM
    from repro_torch.configs import get_config as tget
    from repro_torch.simulate import HW_BY_NAME as THW, StepTimeModel as TSTM
    grid = (("llama31-8b", "tpu-v5e", "bf16", 1),
            ("qwen3-30b-a3b", "tpu-v6e", "fp8", 1),
            ("mixtral-8x7b", "tpu-v5p", "bf16", 2),
            ("phi3-medium-14b", "tpu-v5e", "int8", 4),
            ("xlstm-350m", "tpu-v5e", "bf16", 1))     # kv-free: slope 0
    jm = jfleet.FleetStepModel([JSTM(jget(a), JHW[hw], n_chips=n, quant=q)
                                for a, hw, q, n in grid])
    tm = tfleet.FleetStepModel([TSTM(tget(a), THW[hw], n_chips=n, quant=q)
                                for a, hw, q, n in grid])
    b = np.asarray([1.0, 8.0, 3.0, 64.0, 2.0])
    ctx = np.asarray([512.0, 700.5, 80.0, 4096.0, 10.0])
    k = np.asarray([1.0, 7.0, 100.0, 3.0, 12.0])
    for name in ("decode_time", "decode_time_multi", "prefill_time"):
        args = (b, ctx, k) if name == "decode_time_multi" else (b, ctx)
        assert np.array_equal(getattr(tm, name)(*args),
                              getattr(jm, name)(*args)), name


def test_vector_backend_equals_process_backend():
    from repro_torch.experiments.runner import execute_cells
    plan = texp.get_plan("mini_crosshw")
    process = texp.PlanRunner(plan).run(parallel=False, backend="process")
    vector = texp.PlanRunner(plan).run(parallel=False, backend="vector")
    _assert_records_equal(process, vector, "vector")
    # 32 lanes: two minimum-width chunks, so the pool runs them
    cells = list(plan.cells) + list(texp.get_plan("mini_ensemble").cells)
    pooled = execute_cells(cells, parallel=True, max_workers=2,
                           backend="vector", lane_width=5)
    _assert_records_equal(execute_cells(cells, parallel=False), pooled,
                          "vector-pool")


def test_vector_store_files_are_byte_identical(tmp_path):
    def run(exp, root):
        plan = exp.get_plan("mini_crosshw")
        store = exp.ExperimentStore(plan.name, root)
        exp.PlanRunner(plan, store=store).run(parallel=False,
                                              backend="vector")
        return {p.relative_to(root): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}
    ref = run(jexp, tmp_path / "ref")
    port = run(texp, tmp_path / "port")
    assert len(port) == len(texp.get_plan("mini_crosshw").cells) + 2
    assert port == ref


def test_parallel_sweep_vector_backend_matches_reference():
    kw = dict(ladder=(1, 10, 50), requests_per_point=lambda lam: 80,
              warmup_per_point=lambda lam: 0, config="C1",
              model="llama31-8b", hw="tpu-v5e")
    ref = jcore.lambda_sweep(jcore.SimEngineSpec(
        "llama31-8b", max_batch=64, num_pages=8192), **kw)
    port = tcore.parallel_sweep(tcore.SimEngineSpec(
        "llama31-8b", max_batch=64, num_pages=8192), backend="vector", **kw)
    _assert_records_equal(ref, port, "sweep-vector")


def test_unknown_backend_and_lane_width_are_refused():
    cells = list(texp.get_plan("mini_2x2").cells)
    from repro_torch.experiments.runner import execute_cells
    with pytest.raises(ValueError, match="unknown backend"):
        texp.PlanRunner(texp.get_plan("mini_2x2")).run(parallel=False,
                                                        backend="gpu")
    with pytest.raises(ValueError, match="lane_width"):
        execute_cells(cells, backend="vector", lane_width=0)


# ---- autoscale ----------------------------------------------------------


def _canon(x):
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _canon(dataclasses.asdict(x))
    return x


@pytest.mark.parametrize("name", sorted(jauto.DAY_SCENARIOS))
def test_day_scenarios_price_as_reference(name):
    js, ts = jauto.DAY_SCENARIOS[name], tauto.DAY_SCENARIOS[name]
    assert _canon(ts) == _canon(js)
    for jd, td in zip(js.deployments, ts.deployments):
        jt, tt = js.trajectories(jd), ts.trajectories(td)
        assert _canon(tt) == _canon(jt)
        assert ts.rate_ladder(td) == js.rate_ladder(jd)
        assert ts.static_replicas(td) == js.static_replicas(jd)

        def tps(lam, cap=td.lam_cap):
            return 256.0 * min(lam, cap)

        def ttft(lam, cap=td.lam_cap):
            return 40.0 + 900.0 * (lam / cap) ** 3

        for key in tt:
            kw = dict(price_per_hr=td.price_per_hr, tps_at=tps,
                      lam_cap=td.lam_cap)
            assert _canon(tauto.price_day(tt[key], **kw)) == \
                _canon(jauto.price_day(jt[key], **kw))
        pol = js.policies[0]
        slo_kw = dict(price_per_hr=td.price_per_hr, tps_at=tps,
                      ttft_p90_at=ttft, lam_cap=td.lam_cap)
        jslo = jauto.SLOAutoscalePolicy(name="slo", ttft_p90_slo_ms=500.0)
        tslo = tauto.SLOAutoscalePolicy(name="slo", ttft_p90_slo_ms=500.0)
        assert _canon(tauto.compare_day_policies(
            util_policy=tauto.AutoscalePolicy(**dataclasses.asdict(pol)),
            slo_policy=tslo, rates=ts.window_rates, window_s=ts.window_s,
            **slo_kw)) == _canon(jauto.compare_day_policies(
                util_policy=pol, slo_policy=jslo, rates=js.window_rates,
                window_s=js.window_s, **slo_kw))


def test_simulate_policy_matches_reference():
    kw = dict(name="p", target_util=0.6, scale_up_lag_s=30.0,
              warmup_s=60.0, scale_down_hold_s=90.0, min_replicas=1,
              max_replicas=5)
    for rates in ([1.0, 20.0, 20.0, 20.0, 0.0, 5.0],
                  [40.0, 1.0, 1.0, 1.0, 1.0, 1.0], [0.0] * 4):
        assert _canon(tauto.simulate_policy(tauto.AutoscalePolicy(**kw),
                                            rates, 30.0, 6.0)) == \
            _canon(jauto.simulate_policy(jauto.AutoscalePolicy(**kw),
                                         rates, 30.0, 6.0))
    assert tauto.static_size(34.0, 11.754, util_sla=0.95) == \
        jauto.static_size(34.0, 11.754, util_sla=0.95) == 4
