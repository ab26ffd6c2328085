"""PlanRunner: execution backends for experiment cells.

A copy of `repro.experiments.runner`. Three backends behind one
`execute_cells` surface:

* ``backend="process"`` — every cell is an independent (engine, arrival
  stream) measurement fanned cell-at-a-time across the process pool
  (fork while the parent is torch-free, spawn otherwise).
* ``backend="vector"`` — the fleet path: sim-tier cells are chunked into
  *lanes* of the struct-of-arrays fleet simulator
  (`repro_torch.serving.fleet`), so one Python event loop advances a whole
  chunk at once, and chunks still fan out across the pool (lanes x
  cores). Cells the fleet cannot take (custom engine factories that are
  not `SimEngineSpec`, `fast_forward=False` reference runs) silently take
  the per-cell path; records are bit-identical either way, so the
  backend is purely an execution knob. Resume granularity: in-process
  chunks stream each lane's record into the store the moment the lane
  finishes (per-cell, like the process backend); pool-dispatched chunks
  land at chunk completion, so a killed pooled run can lose at most one
  chunk per worker. A vector run never imports torch.
* ``backend="jit"`` — the accelerator-resident fleet
  (`repro_torch.serving.fleet_jit`): same lane partitioning, but each
  chunk runs the fleet's whole event loop as one launch of the
  `kernels.fleet_loop` CUDA kernel (one thread a lane). Records agree
  with the numpy oracle within `serving.precision.jit_tolerance()` —
  commit stores with the vector/process backends, sweep with jit. Points
  the loop cannot express fall back through the numpy fleet
  automatically, and checkpoint granularity is per chunk. `device`
  chooses where: the card by default (raising without one), or
  ``device="cpu"`` for the loop's plain PyTorch version. A process that
  has initialised CUDA cannot fork workers, so on the card the chunks
  run in the calling process, one launch a chunk, whatever `parallel`
  says; on the CPU the jit backend keeps the pool.

Pooled lane chunks are *work-stolen*: instead of pre-slicing the lanes
into fixed >=16-wide chunks (where a ragged lambda-ladder's slowest chunk
idles every other worker at the tail), workers draw successive chunks
from a shared queue, each sized to the work remaining — wide while the
queue is deep, down to `MIN_FLEET_LANE_WIDTH` near the tail. Chunking is
an execution detail: records (and therefore stores) are byte-identical
to the fixed chunker.

`default_mp_context` forks only while ``"torch"`` is not in
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
import collections
import concurrent.futures
import functools
import multiprocessing
import pickle
import sys
import warnings
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.records import RunRecord
from repro_torch.core.sweep import SimEngineSpec, run_point
from repro_torch.experiments.plan import Cell, ExperimentPlan
from repro_torch.experiments.store import ExperimentStore, backfill_theta

# max lanes per fleet chunk: wide enough to amortize the vectorized event
# loop, small enough that (lanes x requests) request-stream arrays stay a
# few MB and chunks spread across pool workers
FLEET_LANE_WIDTH = 128
# the jit backend amortizes one kernel launch over the whole chunk;
# wider is strictly better until the (lanes x requests) logs hit memory
JIT_LANE_WIDTH = 512
# never split below this under the pool: a chunk's round count is set by
# its slowest lane, so narrow chunks lose the amortization that makes the
# fleet fast (width 1 would be the scalar path plus IPC)
MIN_FLEET_LANE_WIDTH = 16


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


def _fleet_runner(backend: str, device: Optional[str] = None) -> Callable:
    """The lane-chunk runner of a fleet backend: the numpy fleet, or the
    fleet loop on `device` (imported here: a vector run loads no torch)."""
    if backend == "jit":
        from repro_torch.serving.fleet_jit import jit_run_points
        return functools.partial(jit_run_points, device=device)
    from repro_torch.serving.fleet import fleet_run_points
    return fleet_run_points


def _fleet_task(points, cells: Optional[List[Cell]] = None,
                checkpoint=None, backend: str = "vector",
                device: Optional[str] = None) -> List[RunRecord]:
    """Fleet-chunk pool task: run a lane chunk in one vectorized engine
    (numpy fleet, or the fleet loop under ``backend="jit"``, on
    `device`).

    With a checkpoint handle, each lane's record is written to the store
    *from the worker* the moment the lane finishes — a chunk killed
    mid-flight (SIGKILL, OOM) loses only its in-flight lanes on resume
    instead of the whole chunk (writes are atomic; the parent's own
    `on_result` write at chunk completion is byte-identical)."""
    _run = _fleet_runner(backend, device)
    store = _checkpoint_store(checkpoint)
    if store is None or cells is None:
        return _run(points)

    def _ckpt(j: int, rec: RunRecord):
        store.write_cell(cells[j], rec)

    return _run(points, on_result=_ckpt)


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


def _fleet_eligible(cell: Cell, factory: Optional[Callable]) -> bool:
    """A cell can ride a fleet lane iff its engine is a sim-tier
    fast-forward SimEngineSpec (the fleet IS the fast-forward scheduler;
    reference-loop cells and closure factories take the per-cell path)."""
    if factory is not None and not isinstance(factory, SimEngineSpec):
        return False
    spec = factory if factory is not None else cell.engine_spec()
    return bool(spec.fast_forward)


def _fleet_point(cell: Cell, factory: Optional[Callable]):
    from repro_torch.serving.fleet import FleetPoint
    spec = factory if isinstance(factory, SimEngineSpec) \
        else cell.engine_spec()
    return FleetPoint(engine=spec, arrivals=cell.arrival_spec(),
                      warmup=cell.warmup, horizon=cell.horizon,
                      failure_times=cell.failure_times,
                      failure_spec=cell.failure_spec(),
                      retry=cell.retry_policy(), **cell.record_kw())


def _chunk(idxs: List[int], width: int) -> List[List[int]]:
    return [idxs[i:i + width] for i in range(0, len(idxs), width)]


def execute_cells(cells: Sequence[Cell], *,
                  factory: Optional[Callable] = None,
                  parallel: bool = True,
                  max_workers: Optional[int] = None,
                  mp_context: Optional[str] = None,
                  backend: str = "process",
                  lane_width: Optional[int] = None,
                  on_result: Optional[Callable[[Cell, RunRecord],
                                               None]] = None,
                  checkpoint=None,
                  worker_timeout: Optional[float] = None,
                  device: Optional[str] = None
                  ) -> List[RunRecord]:
    """Run `cells`; returns records in cell order. `on_result` fires per
    finished cell *in completion order* (the store hook). The shared
    engine-room of `PlanRunner` and `core.sweep.parallel_sweep`.

    backend="vector" chunks fleet-eligible cells into lanes of the
    vectorized fleet simulator and composes with the pool (lanes x
    cores); records are identical to backend="process" bit-for-bit.
    backend="jit" runs the chunks on the fleet-loop kernel instead
    (tolerance-equivalent records; see `serving.fleet_jit`) on `device`:
    the card by default, in this process, one launch a chunk, whatever
    `parallel` says; raises without a card unless ``device="cpu"``, which
    runs the loop's plain version and keeps the pool. Pooled chunks are
    drawn work-stealing from a shared lane queue.

    `checkpoint=(plan_name, store_root)` lets pool *workers* write each
    finished cell to the store themselves (atomic), so a worker killed
    mid-chunk loses only in-flight lanes on `--resume`.

    `worker_timeout` (seconds) bounds how long the dispatcher waits for
    *any* unit to finish before declaring the pool wedged: the pool is
    killed and unfinished cells are re-dispatched on a fresh pool,
    bounded by each cell's `cell_retries` budget.
    """
    if backend not in ("process", "vector", "jit"):
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'process', 'vector' or 'jit'")
    if lane_width is not None and lane_width < 1:
        raise ValueError(f"lane_width must be >= 1, got {lane_width}")
    if backend == "jit" and str(device) != "cpu":
        # a process that has initialised CUDA cannot fork workers, so the
        # card's chunks run here; lanes are independent, so records do not
        # depend on chunking
        from repro_torch.serving.executors import resolve_device
        device = str(resolve_device("cuda" if device is None else device))
        parallel = False
    results: Dict[int, RunRecord] = {}

    if parallel and len(cells) > 1:
        try:
            pickle.dumps(factory)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            fallback_warning(f"engine factory is not picklable: {e!r}")
            parallel = False

    # -- partition work into units (per-cell or fleet chunks) ----------
    if backend in ("vector", "jit"):
        lane_idx = [i for i, c in enumerate(cells)
                    if _fleet_eligible(c, factory)]
        lane_set = set(lane_idx)
        solo_idx = [i for i in range(len(cells)) if i not in lane_set]
        width_cap = lane_width or (JIT_LANE_WIDTH if backend == "jit"
                                   else FLEET_LANE_WIDTH)
    else:
        lane_idx, solo_idx = [], list(range(len(cells)))
        width_cap = FLEET_LANE_WIDTH

    def _run_chunk_serial(chunk: List[int]):
        _run = _fleet_runner(backend, device)

        # in-process chunks stream per lane as lanes finish — the store
        # hook fires per cell, so a killed run loses only in-flight lanes
        def _stream(j: int, rec: RunRecord):
            results[chunk[j]] = rec
            if on_result:
                on_result(cells[chunk[j]], rec)

        _run([_fleet_point(cells[i], factory) for i in chunk],
             on_result=_stream)

    def _serial_missing():
        for chunk in _chunk(lane_idx, max(1, width_cap)):
            missing = [i for i in chunk if i not in results]
            if missing:
                _run_chunk_serial(missing)
        for i in solo_idx:
            if i not in results:
                results[i] = run_cell(cells[i], factory)
                if on_result:
                    on_result(cells[i], results[i])

    # pool sizing: every solo cell is a unit; lanes count as the number
    # of minimum-width chunks they could split into under work stealing
    n_units = -(-len(lane_idx) // MIN_FLEET_LANE_WIDTH) + len(solo_idx)
    if parallel and n_units > 1:
        ctx_name = mp_context or default_mp_context()
        attempts: Dict[int, int] = {}      # per-cell re-dispatch count
        todo_lanes, todo_solo = list(lane_idx), list(solo_idx)
        while todo_lanes or todo_solo:
            try:
                pool = _get_pool(ctx_name,
                                 max_workers or multiprocessing.cpu_count(),
                                 n_units, factory)
            except (ValueError, OSError) as e:
                fallback_warning(f"process pool failed to start: {e!r}")
                break
            pool_size = _POOL["key"][1]
            # -- work-stealing lane queue ------------------------------
            # workers draw chunks sized to the remaining queue: wide
            # while there is plenty (amortization), narrowing toward
            # MIN_FLEET_LANE_WIDTH at the tail so a ragged ladder's
            # final lanes spread across workers instead of riding one
            # slow chunk. Chunk composition cannot change any record —
            # lanes are independent — so stores stay byte-identical to
            # the fixed chunker.
            queue = collections.deque(todo_lanes)
            futs = {}
            pending = set()

            def _steal_chunk():
                if not queue:
                    return
                w = max(MIN_FLEET_LANE_WIDTH,
                        min(width_cap,
                            -(-len(queue) // (2 * pool_size))))
                chunk = [queue.popleft()
                         for _ in range(min(w, len(queue)))]
                fut = pool.submit(_fleet_task,
                                  [_fleet_point(cells[i], factory)
                                   for i in chunk],
                                  [cells[i] for i in chunk]
                                  if checkpoint else None,
                                  checkpoint, backend, device)
                futs[fut] = chunk
                pending.add(fut)

            # keep 2 chunks per worker outstanding so a completion never
            # leaves a worker idle while the dispatcher wakes up
            for _ in range(2 * pool_size):
                _steal_chunk()
            for i in todo_solo:
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
                        tag = futs[fut]
                        # a cell's *own* exception is not in the tuple
                        # below — it propagates, failing fast instead of
                        # silently re-running single-core
                        res = fut.result()
                        pending.discard(fut)
                        if isinstance(tag, list):
                            for i, rec in zip(tag, res):
                                results[i] = rec
                                if on_result:
                                    on_result(cells[i], rec)
                            _steal_chunk()     # refill the worker
                        else:
                            results[tag] = res
                            if on_result:
                                on_result(cells[tag], res)
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
            # fresh pool. Dispatched-but-unfinished cells consume their
            # `cell_retries` budget; cells still in the steal queue were
            # never dispatched and re-enter free. Over-budget cells fall
            # through to the serial path below.
            shutdown_pool(kill=True)
            queued = set(queue)
            todo_lanes, todo_solo, spent = [], [], []
            for tag in futs.values():
                idx_list = tag if isinstance(tag, list) else [tag]
                missing = [i for i in idx_list if i not in results]
                if not missing:
                    continue
                retry_ok = []
                for i in missing:
                    attempts[i] = attempts.get(i, 0) + 1
                    (retry_ok if attempts[i] <= cells[i].cell_retries
                     else spent).append(i)
                if isinstance(tag, list):
                    todo_lanes.extend(retry_ok)
                elif retry_ok:
                    todo_solo.append(tag)
            todo_lanes.extend(sorted(queued))
            n_left = len(todo_lanes) + len(todo_solo)
            if not (n_left or spent):
                break                     # pool died after the last unit
            warnings.warn(
                f"process pool failed ({reason}); re-dispatching {n_left} "
                f"unfinished cell(s) on a fresh pool"
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
            lane_width: Optional[int] = None,
            worker_timeout: Optional[float] = None,
            progress: Optional[Callable[[Cell, RunRecord, int, int],
                                        None]] = None,
            device: Optional[str] = None
            ) -> List[RunRecord]:
        """Run (the remainder of) the plan; returns plan-ordered records
        with theta_max back-filled per ladder group. `device` is where the
        jit backend runs (`execute_cells`)."""
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
                              backend=backend, lane_width=lane_width,
                              on_result=_on_result, checkpoint=checkpoint,
                              worker_timeout=worker_timeout, device=device)
        done.update({c.cell_id: r for c, r in zip(todo, fresh)})
        if self.store is not None:
            return self.store.consolidate(self.plan)
        return backfill_theta(self.plan, done)
