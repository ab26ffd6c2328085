"""Run-record schema + CSV corpus IO (the paper's per-run CSV artifact)."""
from __future__ import annotations

import csv
import dataclasses
import math
from pathlib import Path
from typing import Iterable, List, Optional


@dataclasses.dataclass
class RunRecord:
    config: str                 # e.g. "C1" or free-form
    model: str
    hw: str
    n_chips: int
    quant: str
    engine: str                 # real | sim
    lam: float                  # offered rate (req/s)
    io_shape: str
    n_requests: int
    n_completed: int
    window_s: float             # measurement window (completed-req stats)
    tps: float                  # aggregate output tokens/s
    prompt_tps: float
    ttft_p50_ms: float
    ttft_p90_ms: float
    ttft_p99_ms: float
    tpot_p50_ms: float
    tpot_p99_ms: float
    e2e_p50_ms: float
    e2e_p99_ms: float
    mean_inflight: float
    price_per_hr: float
    c_eff: float                # $/M output tokens
    theta_max: float = 0.0      # filled by sweep post-pass (saturation)
    seed: int = 0
    # resilience axis coordinates + outcome counters; all zero
    # when FailureSpec/RetryPolicy are off, so failure-free records carry
    # the same numbers as before the resilience layer existed.
    mttf: float = 0.0           # 0 = no injected failures
    retry_max: int = 0          # client retry budget (0 = no retries)
    n_shed: int = 0             # arrivals rejected over max_queue_depth
    n_timeout: int = 0          # queue-time deadline expiries
    n_retried: int = 0          # client re-submissions (amplification)
    n_abandoned: int = 0        # permanently given up (budget exhausted)
    # overload-survival counters; all zero without an
    # OverloadPolicy, so classless records regenerate byte-identical.
    n_class_shed: int = 0       # of n_shed: refused by class (not depth cap)
    n_browned: int = 0          # admitted with a brownout-clamped budget
    browned_tokens: int = 0     # output tokens clipped by the clamp
    n_slo_viol: int = 0         # served requests whose TTFT broke the SLO
    interactive_tps: float = 0.0  # delivered interactive-class tokens/s
    #                               (0 unless the cell declares a class_mix)

    @property
    def penalty(self) -> float:
        if self.theta_max <= 0 or self.tps <= 0:
            return math.nan
        return self.theta_max / self.tps

    @property
    def util(self) -> float:
        if self.theta_max <= 0:
            return math.nan
        return self.tps / self.theta_max

    @property
    def goodput_rps(self) -> float:
        """Delivered request rate (completed / window)."""
        if self.window_s <= 0:
            return math.nan
        return self.n_completed / self.window_s

    @property
    def retry_amplification(self) -> float:
        """Submitted attempts per original request (>= 1.0)."""
        if self.n_requests <= 0:
            return math.nan
        return 1.0 + self.n_retried / self.n_requests


FIELDS = [f.name for f in dataclasses.fields(RunRecord)]


def write_csv(path, records: Iterable[RunRecord]):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS + ["penalty", "util"])
        w.writeheader()
        for r in records:
            row = dataclasses.asdict(r)
            row["penalty"] = r.penalty
            row["util"] = r.util
            w.writerow(row)


def read_csv(path) -> List[RunRecord]:
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            row.pop("penalty", None)
            row.pop("util", None)
            kw = {}
            for fld in dataclasses.fields(RunRecord):
                v = row[fld.name]
                kw[fld.name] = (fld.type in ("int", int) and int(float(v))) \
                    or (fld.type in ("float", float) and float(v)) or v
                if fld.type in ("int", int):
                    kw[fld.name] = int(float(v))
                elif fld.type in ("float", float):
                    kw[fld.name] = float(v)
                else:
                    kw[fld.name] = v
            out.append(RunRecord(**kw))
    return out
