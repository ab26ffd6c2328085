"""The concurrency-aware cost model (paper §3) — Eq. (1)-(4).

    C_eff   = P_gpu * 1e6 / (3600 * Theta_achieved(lambda, L))     (3)
    C_naive = P_gpu * 1e6 / (3600 * Theta_max(H, M, Q))            (4)
    U       = Theta_achieved / Theta_max                           (2)
    penalty = C_eff / C_naive = 1 / U

Utilization is a *dependent* variable — these functions never accept it as
an input. Throughput is always aggregate OUTPUT tokens/s (dollars per
million output tokens), matching the paper's pricing basis.
"""
from __future__ import annotations

import math
from typing import Optional


def c_eff(price_per_hr: float, tps: float) -> float:
    """Effective $/M-output-tokens at achieved throughput `tps`."""
    if tps <= 0:
        return math.inf
    return price_per_hr * 1e6 / (3600.0 * tps)


def c_naive(price_per_hr: float, theta_max: float) -> float:
    """Token-volume-model cost at assumed peak throughput."""
    return c_eff(price_per_hr, theta_max)


def utilization(theta_achieved: float, theta_max: float) -> float:
    """U(lambda, L | H, M, Q) — Eq. (2)."""
    if theta_max <= 0:
        return 0.0
    return theta_achieved / theta_max


def underutilization_penalty(theta_achieved: float,
                             theta_max: float) -> float:
    """C_eff/C_naive = 1/U — the factor by which naive estimates understate
    true cost (paper headline: 2.5-24x at 1-10 rps, 36.3x at idle)."""
    u = utilization(theta_achieved, theta_max)
    return math.inf if u <= 0 else 1.0 / u


def littles_law_inflight(lam: float, mean_residence: float) -> float:
    """N = lambda * W."""
    return lam * mean_residence


def tokens_per_dollar(price_per_hr: float, tps: float) -> float:
    if price_per_hr <= 0:
        return math.inf
    return tps * 3600.0 / price_per_hr


def monthly_cost(price_per_hr: float, hours: float = 730.0) -> float:
    return price_per_hr * hours
