"""Measurement-stability analysis (paper §5.8, Table 5): repeat-run CVs."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.records import RunRecord


def cv(vals: Sequence[float]) -> float:
    a = np.asarray([v for v in vals if np.isfinite(v)], float)
    if len(a) < 2 or a.mean() == 0:
        return float("nan")
    return float(a.std(ddof=1) / a.mean() * 100.0)


def stability_table(runs_by_lam: Dict[float, List[RunRecord]]) -> List[dict]:
    """runs_by_lam: lambda -> list of repeat RunRecords (distinct seeds)."""
    rows = []
    for lam in sorted(runs_by_lam):
        rs = runs_by_lam[lam]
        rows.append({
            "lam": lam,
            "n_repeats": len(rs),
            "tps_mean": float(np.mean([r.tps for r in rs])),
            "tps_cv_pct": cv([r.tps for r in rs]),
            "c_eff_mean": float(np.mean([r.c_eff for r in rs])),
            "c_eff_cv_pct": cv([r.c_eff for r in rs]),
            "ttft_p50_cv_pct": cv([r.ttft_p50_ms for r in rs]),
        })
    return rows
