"""The paper's primary contribution: the concurrency-aware cost framework.

    C_eff = f(H, M, Q, lambda; L)           (Eq. 1)

cost.py     — C_eff / C_naive / U / penalty / Little's law (Eq. 2-4)
pricing.py  — accelerator + API price books
sweep.py    — the 7-point lambda-ladder benchmark protocol (§4.3)
crossover.py— corrected self-host-vs-API crossover surface (§3.4, §5.6)
slo.py      — SLA-conditioned operating points (§5.5)
meter.py    — the live operational cost meter (§6.6-6.7)
stability.py— repeat-run CV analysis (§5.8)
records.py  — per-run CSV corpus schema (§7.1)
"""
from repro_torch.core.cost import (  # noqa: F401
    c_eff, c_naive, littles_law_inflight, tokens_per_dollar,
    underutilization_penalty, utilization)
from repro_torch.core.crossover import (  # noqa: F401
    aggregate_points, crossover_lambda, crossover_table, interp_aggregated,
    interp_c_eff, interp_loglog)
from repro_torch.core.meter import CostMeter, MeterSample  # noqa: F401
from repro_torch.core.pricing import API_TIERS, APITier, chip_hour_price  # noqa: F401
from repro_torch.core.records import RunRecord, read_csv, write_csv  # noqa: F401
from repro_torch.core.slo import (  # noqa: F401
    SLOResult, SLOTarget, slo_operating_point)
from repro_torch.core.stability import cv, stability_table  # noqa: F401
from repro_torch.core.sweep import (  # noqa: F401
    LAMBDA_LADDER, SimEngineSpec, lambda_sweep, parallel_sweep, run_point)
