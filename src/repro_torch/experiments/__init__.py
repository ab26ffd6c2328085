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
  runner.py  — PlanRunner + execute_cells with three backends: per-cell
               over the persistent process pool, backend="vector" —
               cells chunked into lanes of the struct-of-arrays fleet
               simulator (bit-identical records) — or backend="jit" — the
               same lanes through the fleet-loop CUDA kernel on the card
               (records within `serving.precision.jit_tolerance()`);
               serial fallback warns instead of hiding.
  plans.py   — the reference's named plans: paper_h100 (42 cells),
               paper_a100 (56 cells), paper_crosshw, paper_atlas,
               paper_ensemble, the day, resilience and flash-crowd stores,
               mini_2x2 / mini_crosshw (smokes), quickstart.
  analyze.py — derives the paper's figures from a store.
  run.py     — CLI: python -m repro_torch.experiments.run --plan mini_2x2

Copies of the reference's modules of the same names; the runner's jit
backend runs on the card (`device`).

`core.sweep.lambda_sweep` / `parallel_sweep` are thin ladder plans over
this machinery.
"""
from repro_torch.experiments.plan import (  # noqa: F401
    Cell, ExperimentPlan, GridSpec, iter_grid, ladder_plan)
from repro_torch.experiments.plans import PLANS, get_plan  # noqa: F401
from repro_torch.experiments.runner import PlanRunner, run_cell  # noqa: F401
from repro_torch.experiments.store import ExperimentStore  # noqa: F401
