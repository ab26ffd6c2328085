"""Plain PyTorch version of the fleet's event loop (the jit fleet backend).

It computes what the reference's compiled phase computes
(`repro.serving.fleet_jit._compiled_phase`, its `lax.while_loop`): every
lane of a chunk is one sim-tier cell whose scheduler state is a handful
of (B,) scalars, advanced one event round at a time until every lane has
finished (or `cap` rounds have passed). The round body is the
reference's, op for op in float64, on (B,) tensors: each masked
`jnp.where` is a `torch.where`, the arrivals search is
`torch.searchsorted(..., right=True)` over the lane's own row, and the
decode budget cut is a masked bisection run until every lane has
converged (the minimal k' is unique, so no fixed probe count is needed).

Inputs (one lane a row; see `serving.fleet_jit._pack`):
  md     — {field: (B,) float64} for the 18 `MODEL_FIELDS` (`is_moe` bool):
           the lane's `FleetStepModel` constants;
  ec     — {n_req, mb, pf_budget, max_pf_reqs, num_pages, uplen, umn,
           uneed (`EC_FIELDS`): (B,) int64; horizon: (B,) float64};
  r_arr  — (B, W) float64 arrival times, each row sorted and padded with
           +inf, W = N_pad + 1 (the last column is the dump column);
  cap    — the round cap.
Returns a dict: live, stall (B,) bool; t, area (B,) float64; ncomp, crd,
ne, rounds (B,) int64; the cohort logs KadmE, QadmE (B, W) int64 and
TfirstE, TfinE (B, W) float64, zero where no cohort wrote (the dump
column holds whatever the last round without an event wrote there).

Integer divisions floor (`//`), as the reference's; every operand is
non-negative where it is used (asserted), so C's truncating division in
the CUDA kernel gives the same integers.
"""
from __future__ import annotations

import torch

MODEL_FIELDS = ("nc", "fixed", "is_moe", "moe_oh", "moe_ratio", "wb",
                "q_ratio", "kv", "ap2", "pdenom", "cdenom", "bwd",
                "ici_denom", "ncm1", "L2", "Lf", "dm", "attn_coef")
EC_FIELDS = ("n_req", "mb", "pf_budget", "max_pf_reqs", "num_pages",
             "uplen", "umn", "uneed")
OUTPUTS = ("live", "stall", "t", "area", "ncomp", "crd", "ne", "rounds",
           "KadmE", "QadmE", "TfirstE", "TfinE")


# -- FleetStepModel mirrors (the reference's op order; serving.fleet) ------
def _collective(md, tokens):
    bytes_ar = (md["L2"] * tokens * md["dm"] * 2.0 * 2.0 *
                md["ncm1"] / md["nc"])
    out = bytes_ar / md["ici_denom"]
    return torch.where(md["nc"] <= 1.0, 0.0, out)


def decode_terms(md, b):
    compute = md["ap2"] * b / md["cdenom"]
    inner = torch.where(md["is_moe"], b * md["moe_ratio"], 1.0)
    touched = torch.minimum(torch.ones_like(b),
                            torch.maximum(md["q_ratio"], inner))
    mem_base = md["wb"] * touched / md["bwd"]
    mem_slope = b * md["kv"] / md["bwd"]
    moe_term = torch.where(md["is_moe"], md["moe_oh"] * b, 0.0)
    const = _collective(md, b) + moe_term + md["fixed"]
    return compute, mem_base, mem_slope, const


def jump(terms, ctx0, kf):
    """k-step decode time from cached `decode_terms` (the closed-form
    series of `FleetStepModel.jump`); lanes with slope 0 divide by zero
    and are overwritten by `flat`."""
    compute, mem_base, slope, const = terms
    mem0 = mem_base + slope * ctx0
    m = torch.ceil((compute - mem0) / slope)
    m = torch.minimum(torch.maximum(m, torch.zeros_like(m)), kf)
    series = (kf - m) * mem0 + slope * (m + kf - 1.0) * (kf - m) / 2.0
    out = m * compute + series + kf * const
    flat = kf * (torch.maximum(compute, mem0) + const)
    return torch.where(slope <= 0.0, flat, out)


def prefill_time(md, n_tok, n_breq):
    mean_len = n_tok / torch.maximum(n_breq, torch.ones_like(n_breq))
    flops = md["ap2"] * n_tok
    flops = flops + md["attn_coef"] * n_tok * mean_len
    compute = flops / md["pdenom"]
    mem_bytes = md["wb"] + 2.0 * n_tok * md["dm"] * 2.0 * md["Lf"]
    memory = mem_bytes / md["bwd"]
    moe_term = torch.where(md["is_moe"], md["moe_oh"] * n_tok, 0.0)
    out = (torch.maximum(compute, memory) + _collective(md, n_tok) +
           moe_term + md["fixed"])
    return torch.where(n_tok == 0.0, 0.0, out)


def _nonneg(x, alive, what):
    if bool((x[alive] < 0).any()):
        raise AssertionError(f"fleet_loop_ref: negative {what} in an "
                             "integer division")


def fleet_loop_ref(md, ec, r_arr, cap: int) -> dict:
    """Run every lane's event loop to completion (or `cap` rounds); see
    the module docstring for the arguments and the returned dict."""
    f64, i64 = torch.float64, torch.int64
    B, W = r_arr.shape
    dump = W - 1
    dev = r_arr.device
    rows = torch.arange(B, device=dev)
    n_req, mb = ec["n_req"], ec["mb"]
    uplen, umn, uneed = ec["uplen"], ec["umn"], ec["uneed"]
    pf_budget, max_pf_reqs = ec["pf_budget"], ec["max_pf_reqs"]
    num_pages, horizon = ec["num_pages"], ec["horizon"]
    one = torch.ones(B, dtype=i64, device=dev)
    zero = torch.zeros(B, dtype=i64, device=dev)
    inf = torch.full((B,), float("inf"), dtype=f64, device=dev)
    keys = r_arr[:, :dump].contiguous()

    def take(arr, idx):
        return arr.gather(1, idx[:, None])[:, 0]

    live = torch.ones(B, dtype=torch.bool, device=dev)
    stall = torch.zeros(B, dtype=torch.bool, device=dev)
    t = torch.zeros(B, dtype=f64, device=dev)
    area = torch.zeros(B, dtype=f64, device=dev)
    K, q_next, arrived, ncomp, crd, ne, ctx_sum, head_K, head_Q, rounds = (
        zero.clone() for _ in range(10))
    KadmE = torch.zeros((B, W), dtype=i64, device=dev)
    QadmE = torch.zeros((B, W), dtype=i64, device=dev)
    TfirstE = torch.zeros((B, W), dtype=f64, device=dev)
    TfinE = torch.zeros((B, W), dtype=f64, device=dev)
    i = 0
    while bool(live.any()) and i < cap:
        rounds = rounds + live.to(i64)
        n_occ = q_next - ncomp
        live = live & ((arrived < n_req) | (q_next < arrived) | (n_occ > 0))
        alive = live
        # 1. horizon
        hb = alive & (t >= horizon)
        live, alive = live & ~hb, alive & ~hb
        # 3. idle regime: jump to the next arrival, replay the horizon
        next_arr = take(r_arr, arrived)
        idle = (alive & (n_occ == 0) & (q_next == arrived)
                & (arrived < n_req) & (next_arr > t))
        t = torch.where(idle, t + torch.maximum(next_arr - t,
                                                torch.full_like(t, 1e-6)), t)
        hb = idle & (t >= horizon)
        live, alive = live & ~hb, alive & ~hb
        # 4. arrivals (np.searchsorted side="right"; inf padding)
        move = alive & (next_arr <= t)
        if bool(move.any()):
            found = torch.searchsorted(keys, t[:, None], right=True)[:, 0]
            arrived = torch.where(move, found, arrived)
        next_arr = take(r_arr, arrived)
        # 5. admission: the numpy fast path's closed-form FCFS count
        free_pages = (num_pages - one) - n_occ * uneed
        n_free = mb - n_occ
        can = (alive & (q_next < arrived) & (n_occ < mb)
               & (free_pages >= uneed))
        _nonneg(pf_budget, can, "prefill budget")
        _nonneg(free_pages, can, "free page count")
        n = torch.maximum(pf_budget // uplen, one)
        n = torch.minimum(n, max_pf_reqs)
        n = torch.minimum(n, arrived - q_next)
        n = torch.minimum(n, free_pages // uneed)
        n = torch.minimum(n, n_free)
        cnt = torch.where(can, n, zero)
        had_batch = cnt > 0
        # 6. prefill
        n_tok = cnt * uplen
        dt = prefill_time(md, n_tok.to(f64), cnt.to(f64))
        n_occ = n_occ + cnt
        t = torch.where(had_batch, t + dt, t)
        area = torch.where(had_batch, area + n_occ.to(f64) * dt, area)
        ctx_sum = ctx_sum + n_tok
        q_next = q_next + cnt
        # cohort event log (one cohort per admission round)
        col = torch.where(had_batch, ne, torch.full_like(ne, dump))
        KadmE[rows, col] = K
        QadmE[rows, col] = q_next
        TfirstE[rows, col] = t
        new_head = (crd == ne) & had_batch
        ne = ne + had_batch.to(i64)
        head_K = torch.where(new_head, K, head_K)
        head_Q = torch.where(new_head, q_next, head_Q)
        # 7. decode: closed-form jump, event-budget bisection
        dec = alive & (n_occ > 0)
        rem = (head_K + (umn - one)) - K
        k = torch.maximum(torch.where(had_batch, one, rem), one)
        q_empty = q_next == arrived
        cand = torch.where(q_empty & (arrived < n_req), next_arr - t, inf)
        cand = torch.minimum(cand, horizon - t)
        n_eff = torch.maximum(n_occ, one)
        b = n_eff.to(f64)
        ctx0 = ctx_sum.to(f64) / n_eff.to(f64)
        terms = decode_terms(md, b)
        dtd = jump(terms, ctx0, k.to(f64))
        bis = dec & (k > one) & (dtd >= cand)
        if bool(bis.any()):
            # smallest k' in [1, k] with S(k') >= budget: S is strictly
            # increasing, so the minimal k' is unique
            lo, hi = one.clone(), k.clone()
            while True:
                act = bis & (lo < hi)
                if not bool(act.any()):
                    break
                mid = (lo + hi) // 2
                ge = jump(terms, ctx0, mid.to(f64)) >= cand
                hi = torch.where(act & ge, mid, hi)
                lo = torch.where(act & ~ge, mid + one, lo)
            k = torch.where(bis, lo, k)
            dtd = torch.where(bis, jump(terms, ctx0, k.to(f64)), dtd)
        t = torch.where(dec, t + dtd, t)
        area = torch.where(dec, area + n_occ.to(f64) * dtd, area)
        ctx_sum = torch.where(dec, ctx_sum + k * n_occ, ctx_sum)
        K = torch.where(dec, K + k, K)
        # 8. completion: at most one cohort per round
        done_c = dec & (crd < ne) & (head_K <= K - (umn - one))
        ndone = torch.where(done_c, head_Q - ncomp, zero)
        ncomp = ncomp + ndone
        ctx_sum = ctx_sum - ndone * (uplen + (umn - one))
        TfinE[rows, torch.where(done_c, crd, torch.full_like(crd, dump))] = t
        crd = crd + done_c.to(i64)
        head_K = torch.where(done_c, take(KadmE, crd), head_K)
        head_Q = torch.where(done_c, take(QadmE, crd), head_Q)
        # 9. no work: advance to the next arrival or flag a stall
        nw = alive & ~had_batch & ~dec
        pend = nw & (arrived < n_req)
        t = torch.where(pend, t + torch.maximum(next_arr - t,
                                                torch.full_like(t, 1e-6)), t)
        stall = stall | (nw & ~pend & (q_next < arrived))
        live = live & ~(nw & ~pend)
        i += 1
    return {"live": live, "stall": stall, "t": t, "area": area,
            "ncomp": ncomp, "crd": crd, "ne": ne, "rounds": rounds,
            "KadmE": KadmE, "QadmE": QadmE, "TfirstE": TfirstE,
            "TfinE": TfinE}
