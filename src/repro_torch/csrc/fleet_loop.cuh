// One lane of the fleet's event loop, in float64 with no fused multiply-add.
//
// Included by fleet_loop.cu. Everything here is a __device__ function of
// one lane (one thread): the FleetStepModel mirrors, the round body and
// the loop. See fleet_loop.cu for what it replaces and why it is shaped so.
//
// Rounding. The numpy fleet rounds after every product, sum and quotient,
// and its records are bitwise commitments. nvcc contracts a*b + c into one
// DFMA (one rounding fewer) under its default flags, which is the cause of
// the reference's inexact fields on XLA (its FMA contraction). So every
// product, sum, difference and quotient here is an explicit __dmul_rn /
// __dadd_rn / __dsub_rn / __ddiv_rn, which nvcc never contracts: the PTX
// holds mul.rn, add.rn, sub.rn and div.rn.f64 and no fma.f64 (chip_smoke.py
// counts them). ptxas expands each div.rn.f64 into a reciprocal estimate
// refined by DFMAs, which IEEE 754 rounds correctly, so the SASS holds
// DFMAs that only divide.
#pragma once

#include <stdint.h>

namespace fleet {

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// np.maximum / np.minimum: a NaN in either operand is the result (CUDA's
// fmax/fmin return the other operand).
__device__ __forceinline__ double vmax(double a, double b) {
  return a != a ? a : (b != b ? b : (a >= b ? a : b));
}
__device__ __forceinline__ double vmin(double a, double b) {
  return a != a ? a : (b != b ? b : (a <= b ? a : b));
}

// The 18 per-lane constants of `FleetStepModel` (`MODEL_FIELDS` order).
struct Model {
  double nc, fixed, is_moe, moe_oh, moe_ratio, wb, q_ratio, kv, ap2, pdenom,
      cdenom, bwd, ici_denom, ncm1, L2, Lf, dm, attn_coef;
};

// -- FleetStepModel mirrors (the reference's operation order:
//    serving/fleet.py, and serving/fleet_jit.py's compiled phase) -----------

__device__ __forceinline__ double collective(const Model& md, double tokens) {
  // L2 * tokens * dm * 2.0 * 2.0 * ncm1 / nc, then / ici_denom
  if (md.nc <= 1.0) return 0.0;
  const double bytes_ar = div_rn(
      mul(mul(mul(mul(mul(md.L2, tokens), md.dm), 2.0), 2.0), md.ncm1),
      md.nc);
  return div_rn(bytes_ar, md.ici_denom);
}

struct Terms {
  double compute, mem_base, slope, cst;
};

__device__ __forceinline__ Terms decode_terms(const Model& md, double b) {
  Terms tm;
  tm.compute = div_rn(mul(md.ap2, b), md.cdenom);
  const double inner = md.is_moe != 0.0 ? mul(b, md.moe_ratio) : 1.0;
  const double touched = vmin(1.0, vmax(md.q_ratio, inner));
  tm.mem_base = div_rn(mul(md.wb, touched), md.bwd);
  tm.slope = div_rn(mul(b, md.kv), md.bwd);
  const double moe_term = md.is_moe != 0.0 ? mul(md.moe_oh, b) : 0.0;
  tm.cst = add(add(collective(md, b), moe_term), md.fixed);
  return tm;
}

// The k-step decode time (the closed-form series). A lane whose slope is 0
// takes `flat` before the series divides by zero: the reference computes
// the series anyway and overwrites it, but a NaN would reach vmax first.
__device__ __forceinline__ double jump(const Terms& tm, double ctx0,
                                       double kf) {
  const double mem0 = add(tm.mem_base, mul(tm.slope, ctx0));
  if (tm.slope <= 0.0) return mul(kf, add(vmax(tm.compute, mem0), tm.cst));
  double m = ceil(div_rn(sub(tm.compute, mem0), tm.slope));
  m = vmin(vmax(m, 0.0), kf);
  // (kf - m) * mem0 + slope * (m + kf - 1.0) * (kf - m) / 2.0; the
  // halving is a product by 0.5, the same bits as the quotient by 2.0
  // (nvcc would make that quotient a product it may contract)
  const double series =
      add(mul(sub(kf, m), mem0),
          mul(mul(mul(tm.slope, sub(add(m, kf), 1.0)), sub(kf, m)), 0.5));
  return add(add(mul(m, tm.compute), series), mul(kf, tm.cst));
}

__device__ __forceinline__ double prefill_time(const Model& md, double n_tok,
                                               double n_breq) {
  if (n_tok == 0.0) return 0.0;
  const double mean_len = div_rn(n_tok, vmax(n_breq, 1.0));
  double flops = mul(md.ap2, n_tok);
  flops = add(flops, mul(mul(md.attn_coef, n_tok), mean_len));
  const double compute = div_rn(flops, md.pdenom);
  // wb + 2.0 * n_tok * dm * 2.0 * Lf
  const double mem_bytes =
      add(md.wb, mul(mul(mul(mul(2.0, n_tok), md.dm), 2.0), md.Lf));
  const double memory = div_rn(mem_bytes, md.bwd);
  const double moe_term = md.is_moe != 0.0 ? mul(md.moe_oh, n_tok) : 0.0;
  return add(add(add(vmax(compute, memory), collective(md, n_tok)), moe_term),
             md.fixed);
}

// The lane's engine constants (`EC_FIELDS` order) and horizon.
struct Engine {
  int64_t n_req, mb, pf_budget, max_pf_reqs, num_pages, uplen, umn, uneed;
  double horizon;
};

// First index i in [0, n) with r[i] > t, or n (np.searchsorted, right).
__device__ __forceinline__ int64_t upper_bound(const double* r, int64_t n,
                                               double t) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;   // non-negative: floor == trunc
    if (r[mid] <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct State {
  bool live, stall;
  double t, area;
  int64_t ncomp, crd, ne, rounds;
};

// Run one lane's event loop to completion or `cap` rounds: the body of the
// reference's `lax.while_loop`, for one lane. Each masked update there is a
// branch here; a lane that leaves the loop is exactly a frozen lane there
// (every update of the body is masked by `alive`). `r` is the lane's row of
// arrivals (W entries, +inf padded; W - 1 is the dump column, which the
// reference writes on rounds without an event and which no one reads), and
// the logs are the lane's rows, zero on entry.
__device__ State run_lane(const Model& md, const Engine& ec, const double* r,
                          int64_t W, int64_t cap, int64_t* KadmE,
                          int64_t* QadmE, double* TfirstE, double* TfinE,
                          bool skip_budget_cut) {
  const int64_t dump = W - 1;
  State st;
  st.live = true;
  st.stall = false;
  st.t = 0.0;
  st.area = 0.0;
  st.ncomp = st.crd = st.ne = st.rounds = 0;
  int64_t K = 0, q_next = 0, arrived = 0, ctx_sum = 0, head_K = 0,
          head_Q = 0;
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  while (st.live && st.rounds < cap) {
    st.rounds += 1;
    int64_t n_occ = q_next - st.ncomp;
    if (!(arrived < ec.n_req || q_next < arrived || n_occ > 0)) {
      st.live = false;
      break;
    }
    // 1. horizon
    if (st.t >= ec.horizon) {
      st.live = false;
      break;
    }
    // 3. idle regime: jump to the next arrival, replay the horizon
    double next_arr = r[arrived];
    if (n_occ == 0 && q_next == arrived && arrived < ec.n_req &&
        next_arr > st.t) {
      st.t = add(st.t, vmax(sub(next_arr, st.t), 1e-6));
      if (st.t >= ec.horizon) {
        st.live = false;
        break;
      }
    }
    // 4. arrivals (np.searchsorted side="right" over the row; inf padding)
    if (next_arr <= st.t) arrived = upper_bound(r, dump, st.t);
    next_arr = r[arrived];
    // 5. admission: the closed-form FCFS count. free_pages never drops
    // below 0 (admission takes at most free_pages / uneed cohorts' pages),
    // and where `can` holds it is >= uneed >= 1; pf_budget >= 0 and uplen
    // >= 1 (checked on the host): every quotient below has non-negative
    // operands, where C's truncation equals the reference's floor.
    const int64_t free_pages = (ec.num_pages - 1) - n_occ * ec.uneed;
    const int64_t n_free = ec.mb - n_occ;
    int64_t cnt = 0;
    if (q_next < arrived && n_occ < ec.mb && free_pages >= ec.uneed) {
      int64_t n = ec.pf_budget / ec.uplen;
      n = n > 1 ? n : 1;
      n = n < ec.max_pf_reqs ? n : ec.max_pf_reqs;
      n = n < arrived - q_next ? n : arrived - q_next;
      n = n < free_pages / ec.uneed ? n : free_pages / ec.uneed;
      n = n < n_free ? n : n_free;
      cnt = n;
    }
    const bool had_batch = cnt > 0;
    // 6. prefill, and the cohort's event log
    if (had_batch) {
      const int64_t n_tok = cnt * ec.uplen;
      const double dt = prefill_time(md, static_cast<double>(n_tok),
                                     static_cast<double>(cnt));
      n_occ += cnt;
      st.t = add(st.t, dt);
      st.area = add(st.area, mul(static_cast<double>(n_occ), dt));
      ctx_sum += n_tok;
      q_next += cnt;
      KadmE[st.ne] = K;
      QadmE[st.ne] = q_next;
      TfirstE[st.ne] = st.t;
      if (st.crd == st.ne) {
        head_K = K;
        head_Q = q_next;
      }
      st.ne += 1;
    }
    // 7. decode: closed-form jump, event-budget bisection
    const bool dec = n_occ > 0;
    if (dec) {
      const int64_t rem = (head_K + (ec.umn - 1)) - K;
      int64_t k = had_batch ? 1 : rem;
      k = k > 1 ? k : 1;
      double cand = (q_next == arrived && arrived < ec.n_req)
                        ? sub(next_arr, st.t) : inf;
      cand = vmin(cand, sub(ec.horizon, st.t));
      const double b = static_cast<double>(n_occ);
      const double ctx0 = div_rn(static_cast<double>(ctx_sum), b);
      const Terms tm = decode_terms(md, b);
      double dtd = jump(tm, ctx0, static_cast<double>(k));
      if (k > 1 && dtd >= cand && !skip_budget_cut) {
        // smallest k' in [1, k] with S(k') >= budget: S is strictly
        // increasing, so the minimal k' is unique
        int64_t lo = 1, hi = k;
        while (lo < hi) {
          const int64_t mid = (lo + hi) / 2;
          if (jump(tm, ctx0, static_cast<double>(mid)) >= cand) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        k = lo;
        dtd = jump(tm, ctx0, static_cast<double>(k));
      }
      st.t = add(st.t, dtd);
      st.area = add(st.area, mul(static_cast<double>(n_occ), dtd));
      ctx_sum += k * n_occ;
      K += k;
      // 8. completion: at most one cohort per round
      if (st.crd < st.ne && head_K <= K - (ec.umn - 1)) {
        const int64_t ndone = head_Q - st.ncomp;
        st.ncomp += ndone;
        ctx_sum -= ndone * (ec.uplen + (ec.umn - 1));
        TfinE[st.crd] = st.t;
        st.crd += 1;
        head_K = KadmE[st.crd];
        head_Q = QadmE[st.crd];
      }
    }
    // 9. no work: advance to the next arrival or flag a stall
    if (!had_batch && !dec) {
      if (arrived < ec.n_req) {
        st.t = add(st.t, vmax(sub(next_arr, st.t), 1e-6));
      } else {
        st.stall = st.stall || q_next < arrived;
        st.live = false;
      }
    }
  }
  return st;
}

}  // namespace fleet
