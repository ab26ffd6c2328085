"""The concurrency-aware cost framework, the parts the live meter needs.

cost.py    — C_eff / C_naive / U / penalty / Little's law (Eq. 2-4)
pricing.py — API price book
meter.py   — the live operational cost meter (§6.6-6.7)
"""
from repro_torch.core.cost import (  # noqa: F401
    c_eff, c_naive, littles_law_inflight, tokens_per_dollar,
    underutilization_penalty, utilization)
from repro_torch.core.meter import CostMeter, MeterSample  # noqa: F401
from repro_torch.core.pricing import API_TIERS, APITier  # noqa: F401
