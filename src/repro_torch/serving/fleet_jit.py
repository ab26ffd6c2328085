"""The jit fleet backend: the fleet's event loop as one CUDA kernel.

The reference (`repro.serving.fleet_jit`) compiles the numpy fleet's
event round into one XLA `lax.while_loop`; the port runs the same round
as a hand-written CUDA kernel, one thread a lane, each lane's loop to its
end (`kernels.fleet_loop`, `csrc/fleet_loop.cu`). The numpy fleet
(`serving.fleet`) stays the equivalence oracle.

Why this is not a transliteration of the numpy fleet: the loop carries no
slot tables, which is sound for precisely the lanes the numpy fleet's own
vectorized fast path accepts (uniform request shapes, no failure
tracking, no re-queue fronts):

* Every active slot advances by the same `k` each decode round, so a
  request admitted when the lane's cumulative decode-step counter was
  `K_adm` has `tokens_out = 1 + (K_now - K_adm)` — slot state collapses
  to one per-lane counter `K` plus the admission-time snapshot.
* Admission cohorts therefore complete in FIFO order, and because the
  decode burst `k = min(remaining)` is exactly the *oldest* cohort's
  remaining tokens (never more), **at most one cohort completes per
  round**. Completion becomes a cursor walk, not a slot scan.
* Slot ids never reach a RunRecord on untracked lanes, so the free-slot
  stack is replaced by the count `n_free = max_batch - n_occ`; pages by
  `free_pages = (num_pages - 1) - n_occ * need`.

The loop carries only per-lane scalars plus *cohort event logs* —
per-lane append-only columns (Kadm, cumulative-admitted, first-token
time, finish time) read back on the host, where `r_first`/`r_finish`/
`r_out` are reconstructed with `np.repeat` and fed through the numpy
fleet's own `_lane_record`.

Equivalence and tolerance policy (see `serving.precision`): the kernel
mirrors `FleetStepModel` op for op in float64 with no fused
multiply-add, and the event *decisions* (admission counts, the
bisection of the burst's budget cut, idle jumps, horizon cuts) are
integer/comparison-exact given equal clocks, so records should equal the
numpy oracle's bit for bit; they are held to `precision.jit_tolerance()`,
the reference's bound, and the numpy path remains the byte-identity
surface for committed stores. Points the loop cannot express — variable
request shapes, deterministic failure streams, resilience features,
`max_new <= 1`, statically inadmissible shapes — route to
`fleet_run_points` unchanged (which in turn routes retry-feedback cells
to the scalar engine).

Warmup is skipped, provably: a jit-eligible lane's warmup phase drains
completely and `reset_measurement` zeroes the clocks, so the measured
phase starts from exactly the reset state — the only state a warmup
leaves behind is free-stack *order*, which cannot reach an untracked
lane's record.

`jit_run_points` runs on the card unless asked for the CPU
(``device="cpu"``: the loop's plain PyTorch version). Only the loop's own
`live`/`stall` outputs raise `JitFallback`. With ``device="cpu"`` the
chunk then re-runs on the numpy fleet, as the reference's does; on the
card the error propagates, because every lane `jit_eligible` admits
finishes well inside the cap without a stall, so a lane still live or
stalled there is a fault of the kernel, and its work must not quietly
move to the host. A build or launch error propagates too. `LANES` counts
the lanes that rode the loop, fell back, or were routed to numpy.
torch is imported lazily, as the reference imports JAX.
"""
from __future__ import annotations

import types
from typing import List, Sequence

import numpy as np

from repro_torch.serving import precision
from repro_torch.serving.arrivals import synth_arrays
from repro_torch.serving.fleet import (FleetPoint, FleetStepModel,
                                       _lane_record, _needs_admission,
                                       _needs_scalar, fleet_run_points)

# safety valve: the event loop is bounded by ~4 rounds per request
# (admission, completion, one arrival interrupt, one idle jump); a lane
# still live past this cap indicates a scheduling bug: on the CPU the
# chunk falls back to the numpy oracle instead of looping forever, on the
# card the error propagates
_CAP_PER_REQ = 8
_CAP_FLOOR = 256

_MODEL_FIELDS = ("nc", "fixed", "is_moe", "moe_oh", "moe_ratio", "wb",
                 "q_ratio", "kv", "ap2", "pdenom", "cdenom", "bwd",
                 "ici_denom", "ncm1", "L2", "Lf", "dm", "attn_coef")

# lanes by where they ran: the fleet loop (kernel or plain version), the
# numpy fleet after a `JitFallback`, or the numpy fleet as ineligible
LANES = {"loop": 0, "fallback": 0, "numpy": 0}


class JitFallback(RuntimeError):
    """The loop could not finish the chunk (round-cap hit or a dynamic
    scheduler stall). On the CPU the caller re-runs the chunk on the numpy
    fleet, which either finishes or raises the real error; on the card it
    propagates."""


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------


def jit_eligible(p: FleetPoint, stream) -> bool:
    """True iff this point can ride the jit loop with record-equivalent
    results: untracked, uniform request shape, `max_new >= 2` (so no
    prefill-time completions) and statically admissible (the numpy path
    raises the scheduler-stall error for the rest)."""
    if _needs_scalar(p) or p.failure_times:
        return False
    # admission control / overload / priority classes: the loop has no
    # admission queue, counters, or class streams — these points run on
    # the numpy fleet's explicit admission path
    if _needs_admission(p) or getattr(p.arrivals, "class_mix", ()):
        return False
    times, p_ins, p_outs = stream
    if len(times) == 0:
        return True                       # born-finished lane
    if int(p_ins.min()) != int(p_ins.max()) or \
            int(p_outs.min()) != int(p_outs.max()):
        return False
    uplen, umn = int(p_ins[0]), int(p_outs[0])
    if umn < 2:
        return False
    s = p.engine
    try:
        need = -(-(uplen + umn) // int(s.page_size))
        if (need > int(s.max_pages_per_seq)
                or need > int(s.num_pages) - 1
                or int(s.max_prefill_reqs) <= 0
                or int(s.max_batch) < 1):
            return False
    except (AttributeError, TypeError):
        return False                      # not a SimEngineSpec shape
    return True


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n - 1, 0)).bit_length() if n > 1 else floor)


def _edge_pad(a: np.ndarray, b_pad: int) -> np.ndarray:
    return np.pad(a, (0, b_pad - len(a)), mode="edge")


def _pack(points: Sequence[FleetPoint], streams):
    """The loop's inputs as numpy arrays, lanes padded to a power of two
    (padding lanes are born finished): (md, ec, r_arr, cap, uplen, umn,
    n_req), with md/ec the `fleet_loop` dicts (ec holds the horizon)."""
    from repro_torch.configs import get_config
    from repro_torch.simulate import HW_BY_NAME, StepTimeModel

    fdt, idt = np.float64, np.int64
    B = len(points)
    n_req = np.asarray([len(s[0]) for s in streams], idt)
    N = int(n_req.max()) if B else 0
    n_pad = _pow2(N)
    b_pad = _pow2(B)

    models = []
    for p in points:
        s = p.engine
        models.append(StepTimeModel(get_config(s.arch), HW_BY_NAME[s.hw],
                                    n_chips=s.n_chips, quant=s.quant))
    fm = FleetStepModel(models)
    md = {}
    for name in _MODEL_FIELDS:
        arr = getattr(fm, name)
        if arr.dtype == bool:
            md[name] = _edge_pad(arr, b_pad)
        else:
            md[name] = _edge_pad(arr.astype(fdt), b_pad)

    ivec = lambda key: _edge_pad(                            # noqa: E731
        np.asarray([key(p.engine) for p in points], idt), b_pad)
    uplen = np.asarray(
        [int(s[1][0]) if len(s[0]) else 1 for s in streams], idt)
    umn = np.asarray(
        [int(s[2][0]) if len(s[0]) else 2 for s in streams], idt)
    page_size = np.asarray([int(p.engine.page_size) for p in points], idt)
    uneed = (-(-(uplen + umn) // page_size)).astype(idt)
    ec = {
        "n_req": _edge_pad(n_req, b_pad) if B else n_req,
        "mb": ivec(lambda s: int(s.max_batch)),
        "pf_budget": ivec(lambda s: int(s.prefill_token_budget)),
        "max_pf_reqs": ivec(lambda s: int(s.max_prefill_reqs)),
        "num_pages": ivec(lambda s: int(s.num_pages)),
        "uplen": _edge_pad(uplen, b_pad),
        "umn": _edge_pad(umn, b_pad),
        "uneed": _edge_pad(uneed, b_pad),
        "horizon": _edge_pad(np.asarray(
            [np.inf if p.horizon is None else float(p.horizon)
             for p in points], fdt), b_pad),
    }
    # padding lanes are born finished
    ec["n_req"][B:] = 0

    r_arr = np.full((b_pad, n_pad + 1), np.inf, fdt)
    for i, (times, _pi, _po) in enumerate(streams):
        r_arr[i, :len(times)] = times

    cap = max(_CAP_FLOOR, _CAP_PER_REQ * n_pad)
    return md, ec, r_arr, cap, uplen, umn, n_req


def _run_jit_fleet(points: Sequence[FleetPoint], streams, device) -> List:
    """Run jit-eligible points as lanes of one `fleet_loop` call on
    `device`; returns per-lane RunRecords. Raises `JitFallback` when the
    loop could not finish (caller re-runs on the numpy fleet)."""
    import torch

    from repro_torch.kernels.fleet_loop import fleet_loop

    B = len(points)
    md, ec, r_arr, cap, uplen, umn, n_req = _pack(points, streams)
    N = int(n_req.max()) if B else 0
    out = fleet_loop({k: torch.as_tensor(v, device=device)
                      for k, v in md.items()},
                     {k: torch.as_tensor(v, device=device)
                      for k, v in ec.items()},
                     torch.as_tensor(r_arr, device=device), cap)
    (live, stall, t, area, ncomp, crd, ne, QadmE, TfirstE, TfinE) = [
        out[k].cpu().numpy() for k in ("live", "stall", "t", "area",
                                       "ncomp", "crd", "ne", "QadmE",
                                       "TfirstE", "TfinE")]
    if live[:B].any() or stall[:B].any():
        raise JitFallback(
            "fleet loop did not converge "
            f"(live={int(live[:B].sum())}, stall={int(stall[:B].sum())})")

    # -- host-side record reconstruction (cohort logs -> request rows) --
    r_first = np.full((B, N), np.nan)
    r_finish = np.full((B, N), np.nan)
    r_out = np.zeros((B, N), np.int64)
    r_plen = np.zeros((B, N), np.int64)
    for i in range(B):
        ne_i, crd_i, nc_i = int(ne[i]), int(crd[i]), int(ncomp[i])
        r_plen[i, :] = uplen[i]
        if ne_i == 0:
            continue
        q = QadmE[i, :ne_i].astype(np.int64)
        cnt = np.diff(np.concatenate(([0], q)))
        n_adm = int(q[-1])
        r_first[i, :n_adm] = np.repeat(TfirstE[i, :ne_i], cnt)
        r_out[i, :n_adm] = 1
        if crd_i:
            r_finish[i, :nc_i] = np.repeat(TfinE[i, :crd_i], cnt[:crd_i])
            r_out[i, :nc_i] = umn[i]
    zc = np.zeros(B, np.int64)
    view = types.SimpleNamespace(
        n_req=n_req.astype(np.int64), r_arr=r_arr[:B].astype(np.float64),
        r_plen=r_plen, r_first=r_first, r_finish=r_finish, r_out=r_out,
        t=t[:B].astype(np.float64), area=area[:B].astype(np.float64),
        # jit-eligible lanes have no admission control or classes; the
        # counters _lane_record reads are identically zero
        cnt_shed=zc, cnt_timeout=zc, cnt_abandoned=zc, cnt_class_shed=zc,
        cnt_browned=zc, cnt_browned_tokens=zc, cnt_slo_viol=zc)
    return [_lane_record(view, i, p) for i, p in enumerate(points)]


def jit_run_points(points: Sequence[FleetPoint], on_result=None, *,
                   device=None) -> List:
    """`fleet_run_points` with the fleet loop for every point it can
    express; the rest run on the numpy fleet unchanged. Records agree with
    the numpy oracle within `precision.jit_tolerance()`;
    `on_result(index, record)` fires per lane once its phase completes
    (chunk-granular for the loop's lanes). `device`: the card by default
    (raises without one; a chunk the kernel does not finish raises
    `JitFallback`), or "cpu" for the loop's plain version (a chunk it does
    not finish re-runs on the numpy fleet)."""
    from repro_torch.serving.executors import resolve_device
    device = resolve_device("cuda" if device is None else device)
    if not points:
        return []
    precision.enable_x64()
    streams = [synth_arrays(p.arrivals) for p in points]
    jit_ids = [i for i, p in enumerate(points)
               if jit_eligible(p, streams[i])]
    out: List = [None] * len(points)
    rest = [i for i in range(len(points)) if i not in set(jit_ids)]
    if rest:
        def _sub(j: int, rec):
            out[rest[j]] = rec
            if on_result is not None:
                on_result(rest[j], rec)
        fleet_run_points([points[i] for i in rest], on_result=_sub)
        LANES["numpy"] += len(rest)
    if jit_ids:
        sub_pts = [points[i] for i in jit_ids]
        try:
            recs = _run_jit_fleet(sub_pts, [streams[i] for i in jit_ids],
                                  device)
            LANES["loop"] += len(jit_ids)
        except JitFallback:
            if device.type != "cpu":
                raise
            recs = fleet_run_points(sub_pts)
            LANES["fallback"] += len(jit_ids)
        for j, rec in zip(jit_ids, recs):
            out[j] = rec
            if on_result is not None:
                on_result(j, rec)
    return out
