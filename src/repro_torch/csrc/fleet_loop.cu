// The fleet's event loop for Hopper (sm_90a), float64: one thread a lane.
//
// Replaces: the jit fleet's compiled phase, `_compiled_phase` in
// src/repro/serving/fleet_jit.py (its `phase`, compiled by XLA as one
// `lax.while_loop`), which runs B independent sim-tier cells ("lanes") of
// an experiment plan as one event loop. Each lane's scheduler state is a
// handful of scalars (clock, busy area, cumulative decode steps, queue
// cursors, cohort counters) plus four append-only cohort logs; a round
// admits a cohort (a prefill), then jumps the decode clock to the next
// event in closed form, and retires at most one cohort.
//
// Inputs: md (18, B) float64, one row per `FleetStepModel` field in
// `MODEL_FIELDS` order (is_moe as 0/1); ec (8, B) int64 in `EC_FIELDS`
// order; horizon (B,) float64; r (B, W) float64 arrivals, each row sorted
// and +inf padded (W - 1 is the dump column). Outputs (each lane its own
// entries): live, stall (B,) uint8; t, area (B,) float64; ncomp, crd, ne,
// rounds (B,) int64; the cohort logs KadmE, QadmE (B, W) int64 and TfirstE,
// TfinE (B, W) float64, which the caller zeroes (entries past `ne` stay 0).
//
// What bounds it on this card: neither bytes nor operations. A lane moves a
// few hundred KB at most (its arrivals once, its logs once: 3.35 TB/s makes
// that microseconds) and does ~1e2 float64 operations a round. The rounds
// of one lane are a serial chain (each round's clock is the next round's
// input), thousands of rounds long, and every operation of a round depends
// on the one before; so the time of a launch is its longest lane's rounds
// times the latency of one round. Lanes are independent, so one thread
// carries one lane start to end with its ~18 scalars in registers, and
// nothing is shared or synchronised.
//
// Design: the reference's body masks every update with `jnp.where` over
// all B lanes and runs until the last lane finishes; here each masked
// update is a branch of the lane's own thread, which leaves its loop when
// the lane finishes (a frozen lane there), so a short lane costs nothing
// once done. Both `lax.cond`s (skip the arrival search, skip the budget
// cut) become plain `if`s. The arrival search is an upper bound over the
// lane's row; the budget cut a bisection `while lo < hi` (the minimal k'
// is unique, so the reference's fixed probe count is not needed). Blocks
// of 32 threads, so a chunk's lanes (at most 512) spread over 16 SMs
// rather than sharing a few: a warp's threads run their loops in lockstep
// only as long as their lanes take the same branches.
//
// Rounding (fleet_loop.cuh): every product, sum and quotient is an
// explicit __dmul_rn/__dadd_rn/__dsub_rn/__ddiv_rn, so nothing is
// contracted into a fused multiply-add (the PTX holds no fma.f64) and each
// operation rounds as numpy's does: a lane's records should equal the
// numpy fleet's bit for bit (the gate is still `precision.jit_tolerance()`).
//
// A lane still live at `cap` rounds keeps live = 1 (the host raises
// `JitFallback`, as the reference does). `skip_budget_cut` is the planted
// fault of the checks: it skips the budget cut, so k is not clipped at the
// next arrival or the horizon.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fleet_loop.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int N_MODEL = 18;
constexpr int N_EC = 8;

__global__ void __launch_bounds__(THREADS)
    fleet_loop_kernel(const double* __restrict__ md,
                      const int64_t* __restrict__ ec,
                      const double* __restrict__ horizon,
                      const double* __restrict__ r, uint8_t* live,
                      uint8_t* stall, double* t, double* area, int64_t* ncomp,
                      int64_t* crd, int64_t* ne, int64_t* rounds,
                      int64_t* KadmE, int64_t* QadmE, double* TfirstE,
                      double* TfinE, int B, int64_t W, int64_t cap,
                      int skip_budget_cut) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= B) return;
  double f[N_MODEL];
#pragma unroll
  for (int j = 0; j < N_MODEL; ++j) f[j] = md[static_cast<int64_t>(j) * B + lane];
  const fleet::Model m{f[0], f[1], f[2],  f[3],  f[4],  f[5],
                       f[6], f[7], f[8],  f[9],  f[10], f[11],
                       f[12], f[13], f[14], f[15], f[16], f[17]};
  int64_t e[N_EC];
#pragma unroll
  for (int j = 0; j < N_EC; ++j) e[j] = ec[static_cast<int64_t>(j) * B + lane];
  const fleet::Engine en{e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7],
                         horizon[lane]};
  const int64_t row = static_cast<int64_t>(lane) * W;
  const fleet::State st = fleet::run_lane(
      m, en, r + row, W, cap, KadmE + row, QadmE + row, TfirstE + row,
      TfinE + row, skip_budget_cut != 0);
  live[lane] = st.live ? 1 : 0;
  stall[lane] = st.stall ? 1 : 0;
  t[lane] = st.t;
  area[lane] = st.area;
  ncomp[lane] = st.ncomp;
  crd[lane] = st.crd;
  ne[lane] = st.ne;
  rounds[lane] = st.rounds;
}

}  // namespace

extern "C" int fleet_loop_f64(const void* md, const void* ec,
                              const void* horizon, const void* r, void* live,
                              void* stall, void* t, void* area, void* ncomp,
                              void* crd, void* ne, void* rounds, void* KadmE,
                              void* QadmE, void* TfirstE, void* TfinE, int B,
                              long long W, long long cap, int skip_budget_cut,
                              void* stream) {
  if (B <= 0 || W < 1 || cap < 0) return cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS);
  fleet_loop_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(md), static_cast<const int64_t*>(ec),
      static_cast<const double*>(horizon), static_cast<const double*>(r),
      static_cast<uint8_t*>(live), static_cast<uint8_t*>(stall),
      static_cast<double*>(t), static_cast<double*>(area),
      static_cast<int64_t*>(ncomp), static_cast<int64_t*>(crd),
      static_cast<int64_t*>(ne), static_cast<int64_t*>(rounds),
      static_cast<int64_t*>(KadmE), static_cast<int64_t*>(QadmE),
      static_cast<double*>(TfirstE), static_cast<double*>(TfinE), B,
      static_cast<int64_t>(W), static_cast<int64_t>(cap), skip_budget_cut);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
