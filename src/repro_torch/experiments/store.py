"""Resumable on-disk result store for experiment plans.

Layout (one directory per plan under `results/experiments/`):

    results/experiments/<plan>/
        cell_<cell_id>.json     one finished cell: spec + fingerprint + record
        <plan>.csv              consolidated RunRecord corpus (plan order,
                                theta_max back-filled per ladder group)
        manifest.json           plan summary + per-cell status/fingerprints

Cell files are written atomically (tmp + os.replace) the moment a cell
finishes, so a killed run loses at most the in-flight cells. On restart a
cell is resumed only when its stored fingerprint still matches the plan's
spec — editing the plan invalidates exactly the edited cells.

The consolidated CSV and manifest are derived purely from the plan and
the cell files (no timestamps, fixed ordering), so a resumed run that
finishes the remaining cells emits byte-identical artifacts to an
uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.core.records import RunRecord, write_csv
from repro_torch.experiments.plan import Cell, ExperimentPlan

DEFAULT_ROOT = Path(__file__).resolve().parents[3] / "results" / "experiments"
# The port's examples run and write under this root (listed in
# .gitignore); the committed stores under DEFAULT_ROOT are only read.
EXAMPLES_ROOT = (Path(__file__).resolve().parents[3] / "examples_out"
                 / "experiments")


def _atomic_write(path: Path, text: str):
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def example_store(plan_name: str) -> "ExperimentStore":
    """The store of `plan_name` under `EXAMPLES_ROOT`, first given a copy
    of each cell file of the committed store of that name (under
    `DEFAULT_ROOT`) that it lacks. The committed store is read, never
    written."""
    store = ExperimentStore(plan_name, EXAMPLES_ROOT)
    committed = DEFAULT_ROOT / plan_name
    if committed.is_dir():
        store.dir.mkdir(parents=True, exist_ok=True)
        for path in sorted(committed.glob("cell_*.json")):
            if not (store.dir / path.name).exists():
                shutil.copyfile(path, store.dir / path.name)
    return store


def backfill_theta(plan: ExperimentPlan,
                   records: Dict[str, RunRecord]) -> List[RunRecord]:
    """theta_max = max measured TPS across each ladder group (§4.4), over
    `records` keyed by cell_id; returns records in plan order."""
    by_group: Dict[tuple, List[RunRecord]] = {}
    for c in plan.cells:
        if c.cell_id in records:
            by_group.setdefault(c.group_key, []).append(records[c.cell_id])
    for group in by_group.values():
        theta = max(r.tps for r in group)
        for r in group:
            r.theta_max = theta
    return [records[c.cell_id] for c in plan.cells if c.cell_id in records]


class ExperimentStore:
    def __init__(self, plan_name: str, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else DEFAULT_ROOT
        self.dir = self.root / plan_name
        self.plan_name = plan_name

    def cell_path(self, cell: Cell) -> Path:
        return self.dir / f"cell_{cell.cell_id}.json"

    @property
    def csv_path(self) -> Path:
        return self.dir / f"{self.plan_name}.csv"

    @property
    def manifest_path(self) -> Path:
        return self.dir / "manifest.json"

    # ---- writes -------------------------------------------------------
    def write_cell(self, cell: Cell, record: RunRecord):
        self.dir.mkdir(parents=True, exist_ok=True)
        blob = {
            "cell_id": cell.cell_id,
            "fingerprint": cell.fingerprint(),
            "cell": dataclasses.asdict(cell),
            "record": dataclasses.asdict(record),
        }
        _atomic_write(self.cell_path(cell),
                      json.dumps(blob, indent=1, sort_keys=True))

    def consolidate(self, plan: ExperimentPlan) -> List[RunRecord]:
        """Rebuild CSV + manifest from whatever cells are on disk; pure in
        (plan, cell files), so partial/resumed/reordered runs converge to
        identical bytes once the same cells exist."""
        records = self.load_cell_records(plan)
        done = backfill_theta(plan, records)
        self.dir.mkdir(parents=True, exist_ok=True)
        write_csv(self.csv_path, done)
        manifest = {
            "plan": plan.name,
            "seed": plan.seed,
            "description": plan.description,
            "n_cells": len(plan.cells),
            "n_completed": len(done),
            "cells": [{
                "cell_id": c.cell_id,
                "fingerprint": c.fingerprint(),
                "status": "done" if c.cell_id in records else "pending",
            } for c in plan.cells],
        }
        _atomic_write(self.manifest_path,
                      json.dumps(manifest, indent=1, sort_keys=True))
        return done

    def prune(self, plan: ExperimentPlan) -> List[Path]:
        """Delete orphaned cell files: any `cell_*.json` that no current
        plan cell claims with a matching fingerprint (a plan edit renames
        cell ids, so superseded files would otherwise accumulate forever
        and survive `--fresh`). Consolidated artifacts are untouched —
        the next `consolidate` re-derives them from the surviving cells.
        Returns the removed paths."""
        want = {self.cell_path(c).name: c.fingerprint() for c in plan.cells}
        removed = []
        for path in sorted(self.dir.glob("cell_*.json")):
            try:
                blob = json.loads(path.read_text())
                fingerprint = blob.get("fingerprint") \
                    if isinstance(blob, dict) else None
            except (OSError, json.JSONDecodeError):
                fingerprint = None            # torn write: prune with rest
            if path.name not in want or want[path.name] != fingerprint:
                path.unlink()
                removed.append(path)
        return removed

    # ---- reads --------------------------------------------------------
    def load_cell_records(self, plan: ExperimentPlan) -> Dict[str, RunRecord]:
        """cell_id -> RunRecord for every stored cell whose fingerprint
        still matches the plan (stale results are ignored, hence re-run)."""
        out: Dict[str, RunRecord] = {}
        for cell in plan.cells:
            path = self.cell_path(cell)
            if not path.exists():
                continue
            try:
                blob = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                continue                      # torn write: treat as missing
            if not isinstance(blob, dict) or \
                    blob.get("fingerprint") != cell.fingerprint():
                continue
            record = blob.get("record")
            if not isinstance(record, dict):
                continue                      # payload missing: stale
            try:
                out[cell.cell_id] = RunRecord(**record)
            except TypeError:
                # schema drift (e.g. a cell written by an older RunRecord
                # missing fields, or carrying unknown ones): stale, re-run
                continue
        return out

    def completed_ids(self, plan: ExperimentPlan) -> Set[str]:
        return set(self.load_cell_records(plan))

    def verify(self, plan: ExperimentPlan) -> Dict[str, List[str]]:
        """Integrity check of the on-disk store against `plan`.

        Returns {"issues": [...], "missing": [...]} — `issues` are cell
        files that exist but cannot be resumed (torn JSON, fingerprint
        drift, missing/undecodable record payload) plus orphaned files no
        current cell claims; `missing` lists cells never run (informative
        only: an interrupted run is not corrupt). Every entry names the
        file and the reason, so `run.py --verify` can print and exit
        nonzero on `issues`."""
        issues: List[str] = []
        missing: List[str] = []
        claimed: Set[str] = set()
        for cell in plan.cells:
            path = self.cell_path(cell)
            claimed.add(path.name)
            if not path.exists():
                missing.append(f"{path.name}: cell never ran")
                continue
            try:
                blob = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError) as e:
                issues.append(f"{path.name}: torn/unreadable JSON ({e})")
                continue
            if not isinstance(blob, dict):
                issues.append(f"{path.name}: not a cell blob "
                              f"(top-level {type(blob).__name__})")
                continue
            if blob.get("fingerprint") != cell.fingerprint():
                issues.append(
                    f"{path.name}: fingerprint drift (stored "
                    f"{blob.get('fingerprint')!r} != plan "
                    f"{cell.fingerprint()!r}; spec changed since it ran)")
                continue
            record = blob.get("record")
            if not isinstance(record, dict):
                issues.append(f"{path.name}: record payload missing")
                continue
            try:
                RunRecord(**record)
            except TypeError as e:
                issues.append(f"{path.name}: record schema drift ({e})")
        if self.dir.exists():
            for path in sorted(self.dir.glob("cell_*.json")):
                if path.name not in claimed:
                    issues.append(f"{path.name}: orphaned (no current "
                                  "plan cell claims it)")
        return {"issues": issues, "missing": missing}

    def load_records(self, plan: ExperimentPlan) -> List[RunRecord]:
        """Plan-ordered, theta-back-filled records (the analysis input)."""
        return backfill_theta(plan, self.load_cell_records(plan))
