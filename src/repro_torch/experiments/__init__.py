"""Declarative experiment-matrix subsystem.

The paper's headline numbers come from full benchmark *matrices* — 42
H100 and 56 A100 cells over (model, hardware, quant, lambda) — not from
single lambda ladders. This package turns those matrices into
first-class, resumable objects:

  plan.py    — Cell / GridSpec / ExperimentPlan frozen dataclasses; a grid
               spec expands deterministically (same spec -> same cell list
               and same per-cell seeds, derived from the plan seed).
  store.py   — resumable on-disk result store:
               results/experiments/<plan>/cell_<id>.json per finished cell
               plus a consolidated CSV + manifest; completed cells are
               skipped on restart.
  runner.py  — PlanRunner + execute_cells: per-cell over the persistent
               process pool; serial fallback warns instead of hiding.

Copies of the reference's modules of the same names. The reference's
named plans (`plans.py`) and its fleet backends of `runner.py` are not
ported yet: the plans need `serving.autoscale`, the backends
`serving.fleet` and `serving.fleet_jit`.

`core.sweep.lambda_sweep` / `parallel_sweep` are thin ladder plans over
this machinery.
"""
from repro_torch.experiments.plan import (  # noqa: F401
    Cell, ExperimentPlan, GridSpec, iter_grid, ladder_plan)
from repro_torch.experiments.runner import PlanRunner, run_cell  # noqa: F401
from repro_torch.experiments.store import ExperimentStore  # noqa: F401
