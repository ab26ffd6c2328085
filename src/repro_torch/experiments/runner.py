"""PlanRunner: the process backend for experiment cells.

A copy of `repro.experiments.runner` with two differences:

* Only ``backend="process"`` runs: every cell is an independent (engine,
  arrival stream) measurement fanned cell-at-a-time across the process
  pool. The reference's fleet backends raise `NotImplementedError`:
  ``"vector"`` waits for the port of `serving/fleet.py` and ``"jit"`` for
  that of `serving/fleet_jit.py`. The fleet's lane code and its
  `lane_width` knob are left out with them.
* `default_mp_context` forks only while ``"torch"`` is not in
  `sys.modules` (the reference tests for ``"jax"``), so a parent that may
  have initialised CUDA is never forked. Sim-only parents stay torch-free
  (`serving.executors` imports torch lazily) and still fork.

The process pool is *persistent*: one pool is kept alive across a plan's
chunks and across `--resume` passes instead of being respawned per
`execute_cells` call, and the shared engine factory ships to each worker
once via the pool initializer instead of being re-pickled into every
payload.

Serial fallback is *loud*: an unpicklable factory, a pool start failure or
a broken pool mid-run emits a `RuntimeWarning` naming the reason before
the remaining work degrades to the serial path — results are identical
either way, but silent 1-core runs of a 56-cell matrix are a footgun.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import multiprocessing
import pickle
import sys
import warnings
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.records import RunRecord
from repro_torch.core.sweep import run_point
from repro_torch.experiments.plan import Cell, ExperimentPlan
from repro_torch.experiments.store import ExperimentStore, backfill_theta

# the reference's fleet backends, and what each waits for in the port
FLEET_BACKENDS = {"vector": "serving/fleet.py",
                  "jit": "serving/fleet_jit.py"}


def fallback_warning(reason: str):
    warnings.warn(
        f"parallel execution unavailable ({reason}); "
        "falling back to the serial path (results are identical, just "
        "single-core)", RuntimeWarning, stacklevel=3)


def default_mp_context() -> str:
    """fork while the parent is torch-free (sim-tier workers start in ms);
    spawn otherwise — forking a parent with live torch or CUDA threads can
    hang."""
    if ("fork" in multiprocessing.get_all_start_methods()
            and "torch" not in sys.modules):
        return "fork"
    return "spawn"


def run_cell(cell: Cell, factory: Optional[Callable] = None) -> RunRecord:
    """Execute one cell (top-level, so pool workers can import it under
    spawn). `factory` overrides the cell's own SimEngineSpec — that is how
    ladder plans carry arbitrary (even closure) engine factories."""
    return run_point(factory if factory is not None else cell.engine_spec(),
                     cell.arrival_spec(), warmup=cell.warmup,
                     horizon=cell.horizon,
                     failure_times=cell.failure_times,
                     failure_spec=cell.failure_spec(),
                     retry=cell.retry_policy(), **cell.record_kw())


# ---------------------------------------------------------------------------
# persistent worker pool
# ---------------------------------------------------------------------------

_WORKER_FACTORY: Optional[Callable] = None   # set per worker by _worker_init
_POOL: Dict[str, object] = {}                # the one cached pool + its key


def _worker_init(factory_bytes: Optional[bytes]):
    global _WORKER_FACTORY
    _WORKER_FACTORY = (pickle.loads(factory_bytes)
                       if factory_bytes is not None else None)


def _checkpoint_store(checkpoint) -> Optional[ExperimentStore]:
    """Rebuild the plan's store inside a worker from its (plan_name, root)
    checkpoint handle (the store object itself never crosses the pool)."""
    if checkpoint is None:
        return None
    plan_name, root = checkpoint
    return ExperimentStore(plan_name, root=root)


def _pool_task(cell: Cell, checkpoint=None) -> RunRecord:
    """Per-cell pool task; the factory arrived once via `_worker_init`."""
    rec = run_cell(cell, _WORKER_FACTORY)
    store = _checkpoint_store(checkpoint)
    if store is not None:
        store.write_cell(cell, rec)
    return rec


def shutdown_pool(kill: bool = False):
    """Tear down the persistent pool (atexit, tests, broken-pool reset).
    `kill=True` also terminates the worker processes — required when a
    worker is *wedged* (stuck in a task): plain shutdown(wait=False)
    leaves the stuck process alive and the interpreter joins it at exit."""
    pool = _POOL.pop("pool", None)
    _POOL.pop("key", None)
    if pool is not None:
        if kill:
            for proc in getattr(pool, "_processes", {}).values():
                proc.terminate()
        pool.shutdown(wait=False, cancel_futures=True)


atexit.register(shutdown_pool)


def _get_pool(ctx_name: str, requested: int, n_units: int,
              factory: Optional[Callable]):
    """Reuse one ProcessPoolExecutor across execute_cells calls. A fresh
    pool is sized min(requested, n_units) — a 4-cell smoke must not
    spawn a cpu_count-wide pool — but an already-warm pool with the same
    start method and factory is reused whenever it is big enough and
    within the caller's cap: a plan's chunks and its `--resume`
    re-invocations (which usually have *fewer* units left) hit the same
    warm workers instead of paying a respawn."""
    factory_bytes = pickle.dumps(factory) if factory is not None else None
    size = min(requested, max(n_units, 1))
    key = _POOL.get("key")
    if key is not None:
        c_ctx, c_size, c_bytes = key
        if (c_ctx == ctx_name and c_bytes == factory_bytes
                and size <= c_size <= requested):
            return _POOL["pool"]
    shutdown_pool()
    ctx = multiprocessing.get_context(ctx_name)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=size, mp_context=ctx,
        initializer=_worker_init, initargs=(factory_bytes,))
    _POOL["pool"] = pool
    _POOL["key"] = (ctx_name, size, factory_bytes)
    return pool


# ---------------------------------------------------------------------------
# cell execution
# ---------------------------------------------------------------------------


def execute_cells(cells: Sequence[Cell], *,
                  factory: Optional[Callable] = None,
                  parallel: bool = True,
                  max_workers: Optional[int] = None,
                  mp_context: Optional[str] = None,
                  backend: str = "process",
                  on_result: Optional[Callable[[Cell, RunRecord],
                                               None]] = None,
                  checkpoint=None,
                  worker_timeout: Optional[float] = None
                  ) -> List[RunRecord]:
    """Run `cells`; returns records in cell order. `on_result` fires per
    finished cell *in completion order* (the store hook). The shared
    engine-room of `PlanRunner` and `core.sweep.parallel_sweep`.

    Only backend="process" runs here; "vector" and "jit" raise
    `NotImplementedError` until the port has the fleet modules they need
    (`FLEET_BACKENDS`).

    `checkpoint=(plan_name, store_root)` lets pool *workers* write each
    finished cell to the store themselves (atomic), so a worker killed
    mid-run loses only its in-flight cell on `--resume`.

    `worker_timeout` (seconds) bounds how long the dispatcher waits for
    *any* unit to finish before declaring the pool wedged: the pool is
    killed and unfinished cells are re-dispatched on a fresh pool,
    bounded by each cell's `cell_retries` budget.
    """
    if backend in FLEET_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} runs on the fleet simulator, which the "
            f"port does not have yet ({FLEET_BACKENDS[backend]}); use "
            "backend='process'")
    if backend != "process":
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'process', 'vector' or 'jit'")
    results: Dict[int, RunRecord] = {}

    if parallel and len(cells) > 1:
        try:
            pickle.dumps(factory)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            fallback_warning(f"engine factory is not picklable: {e!r}")
            parallel = False

    def _serial_missing():
        for i in range(len(cells)):
            if i not in results:
                results[i] = run_cell(cells[i], factory)
                if on_result:
                    on_result(cells[i], results[i])

    if parallel and len(cells) > 1:
        ctx_name = mp_context or default_mp_context()
        attempts: Dict[int, int] = {}      # per-cell re-dispatch count
        todo = list(range(len(cells)))
        while todo:
            try:
                pool = _get_pool(ctx_name,
                                 max_workers or multiprocessing.cpu_count(),
                                 len(cells), factory)
            except (ValueError, OSError) as e:
                fallback_warning(f"process pool failed to start: {e!r}")
                break
            futs = {}
            pending = set()
            for i in todo:
                fut = pool.submit(_pool_task, cells[i], checkpoint)
                futs[fut] = i
                pending.add(fut)
            reason = None
            try:
                while pending:
                    done, _ = concurrent.futures.wait(
                        pending, timeout=worker_timeout,
                        return_when=concurrent.futures.FIRST_COMPLETED)
                    if not done:
                        reason = (f"no unit finished within "
                                  f"{worker_timeout:g}s (wedged worker)")
                        break
                    for fut in concurrent.futures.as_completed(done):
                        i = futs[fut]
                        # a cell's *own* exception is not in the tuple
                        # below — it propagates, failing fast instead of
                        # silently re-running single-core
                        res = fut.result()
                        pending.discard(fut)
                        results[i] = res
                        if on_result:
                            on_result(cells[i], res)
            except (concurrent.futures.process.BrokenProcessPool,
                    pickle.PicklingError, EOFError) as e:
                reason = repr(e)
            finally:
                for fut in futs:
                    fut.cancel()
            if reason is None:
                break
            # pool *infrastructure* died (or wedged): kill the cached
            # pool, keep whatever finished (already reported through
            # on_result) and re-dispatch only the unfinished cells on a
            # fresh pool. Unfinished cells consume their `cell_retries`
            # budget; over-budget cells fall through to the serial path
            # below.
            shutdown_pool(kill=True)
            todo, spent = [], []
            for i in futs.values():
                if i in results:
                    continue
                attempts[i] = attempts.get(i, 0) + 1
                (todo if attempts[i] <= cells[i].cell_retries
                 else spent).append(i)
            if not (todo or spent):
                break                     # pool died after the last unit
            warnings.warn(
                f"process pool failed ({reason}); re-dispatching "
                f"{len(todo)} unfinished cell(s) on a fresh pool"
                + (f"; {len(spent)} cell(s) exhausted their re-dispatch "
                   "budget and fall back to the serial path" if spent
                   else ""),
                RuntimeWarning, stacklevel=2)
    if len(results) < len(cells):
        _serial_missing()
    return [results[i] for i in range(len(cells))]


class PlanRunner:
    """Execute an ExperimentPlan against a resumable store.

    With `store=None` the runner is a pure in-memory fan-out (what the
    refactored `lambda_sweep`/`parallel_sweep` use); with a store, each
    finished cell lands on disk immediately and `run(resume=True)` skips
    cells whose stored fingerprint still matches the plan.
    """

    def __init__(self, plan: ExperimentPlan,
                 store: Optional[ExperimentStore] = None,
                 factory: Optional[Callable] = None):
        self.plan = plan
        self.store = store
        self.factory = factory

    def run(self, *, resume: bool = True, parallel: bool = True,
            max_workers: Optional[int] = None,
            mp_context: Optional[str] = None,
            backend: str = "process",
            worker_timeout: Optional[float] = None,
            progress: Optional[Callable[[Cell, RunRecord, int, int],
                                        None]] = None
            ) -> List[RunRecord]:
        """Run (the remainder of) the plan; returns plan-ordered records
        with theta_max back-filled per ladder group."""
        done: Dict[str, RunRecord] = {}
        if self.store is not None and resume:
            done = self.store.load_cell_records(self.plan)
        todo = [c for c in self.plan.cells if c.cell_id not in done]
        n_done = len(done)

        def _on_result(cell: Cell, rec: RunRecord):
            nonlocal n_done
            n_done += 1
            if self.store is not None:
                self.store.write_cell(cell, rec)
            if progress is not None:
                progress(cell, rec, n_done, len(self.plan.cells))

        checkpoint = None
        if self.store is not None:
            checkpoint = (self.store.plan_name, str(self.store.root))
        fresh = execute_cells(todo, factory=self.factory, parallel=parallel,
                              max_workers=max_workers, mp_context=mp_context,
                              backend=backend,
                              on_result=_on_result, checkpoint=checkpoint,
                              worker_timeout=worker_timeout)
        done.update({c.cell_id: r for c, r in zip(todo, fresh)})
        if self.store is not None:
            return self.store.consolidate(self.plan)
        return backfill_theta(self.plan, done)
