"""repro-cost-meter: the paper's live operational cost meter (§6.6, §6.7).

A *meter*, not a calculator: it never asks the operator for a utilization
or a peak-throughput guess. Each tick scrapes the serving engine's
Prometheus text exposition (the same bytes a Grafana dashboard would read),
differences the token counters, and reports the windowed effective
$/M-output-tokens under the operator's own traffic. The engine clock is
also read from the scraped text, so the meter works identically against
the wall-clock and virtual-clock tiers.

The API-comparison feature is gated behind accept_slo_mismatch (paper §6.4:
serverless list prices carry no latency SLA — comparing them to a
dedicated deployment is a category error unless consciously accepted).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from repro_torch.core.cost import c_eff
from repro_torch.core.pricing import API_TIERS
from repro_torch.serving.metrics import parse_prometheus

GEN_TOKENS = "repro:generation_tokens_total"
CLOCK = "repro:time_seconds"
RUNNING = "repro:num_requests_running"


@dataclasses.dataclass
class MeterSample:
    t: float
    window_s: float
    tokens: float
    tps: float
    c_eff: float
    inflight: float


class CostMeter:
    def __init__(self, price_per_hr: float,
                 scrape: Callable[[], str],
                 minute_s: float = 60.0):
        self.price_per_hr = price_per_hr
        self.scrape = scrape
        self.minute_s = minute_s
        self.samples: List[MeterSample] = []
        self._last: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------------
    def tick(self) -> Optional[MeterSample]:
        vals = parse_prometheus(self.scrape())
        if self._last is None:
            self._last = vals
            return None
        dt = vals.get(CLOCK, 0.0) - self._last.get(CLOCK, 0.0)
        dtok = vals.get(GEN_TOKENS, 0.0) - self._last.get(GEN_TOKENS, 0.0)
        self._last = vals
        if dt <= 0:
            return None
        tps = dtok / dt
        s = MeterSample(t=vals.get(CLOCK, 0.0), window_s=dt, tokens=dtok,
                        tps=tps, c_eff=c_eff(self.price_per_hr, tps),
                        inflight=vals.get(RUNNING, 0.0))
        self.samples.append(s)
        return s

    # ------------------------------------------------------------------
    def minute_costs(self) -> List[float]:
        """Aggregate samples into minute windows -> per-minute C_eff.

        An idle window (observed seconds but zero tokens — the diurnal
        trough regime) is kept as an explicit `inf` entry: the
        deployment was billed while delivering nothing. Callers that
        want only busy windows filter on `math.isfinite`."""
        if not self.samples:
            return []
        out, bucket_t, toks, secs = [], None, 0.0, 0.0
        for s in self.samples:
            b = int(s.t // self.minute_s)
            if bucket_t is None:
                bucket_t = b
            if b != bucket_t:
                if secs > 0:
                    out.append(c_eff(self.price_per_hr, toks / secs))
                bucket_t, toks, secs = b, 0.0, 0.0
            toks += s.tokens
            secs += s.window_s
        if secs > 0:
            out.append(c_eff(self.price_per_hr, toks / secs))
        return out

    def summary(self) -> Dict[str, Optional[float]]:
        """Best/worst minute + hourly-average cost (paper Table 7).

        Idle-window semantics: `minutes` counts *all* observed
        windows and `idle_minutes` the zero-goodput ones; an idle window
        makes `worst_minute` inf (cost-at-zero-goodput, flagged rather
        than hidden) and `swing` None — max/min is undefined when a
        window delivered nothing (previously idle windows were silently
        dropped, undercounting `minutes` and understating the swing, and
        a zero-cost minute made `swing` raise ZeroDivisionError)."""
        all_minutes = self.minute_costs()
        finite = [m for m in all_minutes if math.isfinite(m)]
        idle = len(all_minutes) - len(finite)
        total_tok = sum(s.tokens for s in self.samples)
        total_t = sum(s.window_s for s in self.samples)
        avg = c_eff(self.price_per_hr, total_tok / total_t) \
            if total_t > 0 and total_tok > 0 else math.inf
        if idle or not finite or min(finite) <= 0:
            swing: Optional[float] = None
        else:
            swing = max(finite) / min(finite)
        return {
            "best_minute": min(finite) if finite else math.inf,
            "worst_minute": math.inf if idle or not finite else max(finite),
            "swing": swing,
            "time_weighted_avg": avg,
            "minutes": float(len(all_minutes)),
            "idle_minutes": float(idle),
        }

    # ------------------------------------------------------------------
    def compare_api(self, tier: str, *, accept_slo_mismatch: bool = False
                    ) -> Dict[str, float]:
        if not accept_slo_mismatch:
            raise ValueError(
                "--accept-slo-mismatch required: serverless pricing has no "
                "latency SLA counterpart (paper §6.4)")
        api = API_TIERS[tier].output_per_mtok
        cur = self.samples[-1].c_eff if self.samples else math.inf
        return {"api_output_per_mtok": api, "live_c_eff": cur,
                "self_host_cheaper": float(cur < api)}
