// Mamba selective scan for Hopper (sm_90a), fp32 in and out.
//
// Replaces: the Pallas TPU kernel `ssm_scan_kernel` (`_scan_kernel`) in
// src/repro/kernels/ssm_scan/kernel.py. For each sequence b and channel d,
// with an N-wide state h (fp32) that starts at h0[b, d] (or at zero):
//     h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//     y_t = h_t . C_t + D[d] * u_t
// u, dt, y are (B, S, di), B and C (B, S, N), A (di, N), D (di,), h0 and
// h_final (B, di, N), all row-major fp32. Any S (0 too) and di; N 4 or 16.
//
// What bounds it on this card: at the served prefill shape (B 8, S 512,
// di 8192, N 16) the B*S*di*N exponentials, one MUFU.EX2 each at 16 a
// clock per SM (0.128 ms at 1.98 GHz), just ahead of the device-memory
// bytes (u, dt and y once each, 0.122 ms at 3.35 TB/s); the fp32 FMAs
// (~6 an element) would take 0.05 ms. So the design spends as few issue
// slots as it can beside each MUFU, and overlaps the loads with it. At
// decode (S 1) the bytes of h0, A and h_final bound it (2.9 us), and a
// launch is mostly latency.
//
// Design, prefill (S != 1): one thread owns one (b, d) and keeps its N
// states and its row of A in registers for the whole sequence (the TPU
// kernel's sequential chunk axis, which carried h in VMEM scratch, is the
// loop inside the thread). A block covers 128 consecutive channels of one
// b, and walks time in chunks of 16 steps through a ring of 2 stages in
// shared memory: every thread issues 16-byte cp.async copies of u and dt
// (a warp copies 512 contiguous bytes of one time step) and of the
// chunk's B and C rows (shared by every channel, read back as broadcasts),
// and the threads run chunk k while chunk k+1 is in flight; one
// __syncthreads a chunk. y goes to one of two chunk buffers in shared
// memory, and a chunk's y leaves as 16-byte stores of 4 channels during
// the next chunk (6% faster than a 4-byte store a step from registers).
// The grid, ceil(di / 128) x B blocks, is 512 blocks at the served shape:
// 4 resident an SM (52 KB of shared memory and at most 128 registers a
// thread each) hold all of them on 132 SMs, so every block, which runs
// the whole sequence, starts in the first wave (`ssm_scan_layout`
// reports the count; chunks of 32 or a third stage would leave 2 or 3
// an SM). One lane a channel: splitting N over 2 or 4 lanes adds a
// shuffle reduction of y and per-lane copies of the step's scalars, issue
// slots that the MUFU pipe does not need (14% and 74% slower; these
// figures are scripts/ssm_variants.py's, on an H100 SXM at 700 W).
// Where di is not a multiple of 4 or an operand is not 16-byte aligned,
// the same kernel copies 4 bytes at a time and stores y a step at a time.
//
// Design, decode (S == 1, chosen on the host; still one launch): 4 states
// a lane (N / 4 lanes a channel), so h0, A and h_final move as float4s on
// consecutive addresses (a warp reads 512 contiguous bytes), y is reduced
// over the channel's lanes with shuffles, and nothing is staged.
//
// Exponentials: exp(x) = 2^(x log2 e), taken as ex2.approx.ftz.f32 (inline
// PTX, one MUFU.EX2 and no range reduction; expf is ~8 instructions) of
// dt * a2, where a2 = fl(A * log2 e) is formed once a thread. Rounding:
// a2 carries A log2 e within 2^-24 relative, and dt * a2 adds another
// 2^-24, so 2^(dt a2) is e^(dt A) (1 + r) with |r| <= |dt A| 2^-23 plus
// ex2's own error (2 ulp, as the CUDA math guide gives for exp2f, which
// is this instruction with subnormal handling). The first term is largest
// where the state decays fastest, so it never accumulates past a relative
// 2^-23 per unit of decay the state remembers; the second adds a few ulps
// a step, as expf did. Both stay within `fp32_gate` (1e-5 + 1e-4 |ref|),
// as the plain version's own expf does against the exact recurrence.
// ftz: a subnormal argument (|dt a2| < 1.2e-38) becomes 0, and 2^0 = 1 is
// the exact result rounded; a result below 2^-126 becomes 0, an absolute
// error under 1.2e-38.
// The card agrees with the plain version to that gate, not bit for bit:
// the update is one FMA (dA * h + du * B) and y sums N products in 4
// partial sums.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BD = 128;             // channels a block
constexpr int LANES = 1;            // lanes a channel (N split over them)
constexpr int THREADS = BD * LANES;
constexpr int CHUNK = 16;           // time steps a ring stage holds
constexpr int STAGES = 2;           // ring depth
constexpr int MIN_BLOCKS = 4;       // resident blocks an SM must hold
constexpr bool STAGE_Y = true;      // y through shared memory, float4 out
constexpr int STEP_THREADS = 256;   // decode
constexpr float LOG2E = 1.4426950408889634f;
constexpr float A_SCALE = LOG2E;    // A is held as A * A_SCALE

__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// e^(dt A) given dt * (A * A_SCALE)
__device__ __forceinline__ float scan_exp(float x) { return exp2_approx(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K consecutive floats at p into r; p 16-byte aligned where K % 4 == 0
template <int K>
__device__ __forceinline__ void load(float (&r)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(p)[j];
      r[4 * j] = v.x; r[4 * j + 1] = v.y; r[4 * j + 2] = v.z;
      r[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = p[j];
  }
}

template <int K>
__device__ __forceinline__ void store(float* p, const float (&r)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = r[j];
  }
}

// floats of one ring stage: u and dt (CHUNK x BD), B and C (CHUNK x N)
template <int N>
__host__ __device__ constexpr int stage_floats() {
  return CHUNK * (2 * BD + 2 * N);
}

template <int N>
__host__ __device__ constexpr int smem_bytes() {
  return (STAGES * stage_floats<N>() + (STAGE_Y ? 2 * CHUNK * BD : 0)) * 4;
}

// Store a chunk's y, staged as sy[CHUNK][BD], as 16-byte rows of 4 channels
// (di % 4 == 0).
__device__ __forceinline__ void flush_y(const float* sy, float* __restrict__ y,
                                        size_t row, int len, int d0, int di) {
  constexpr int PER_ROW = BD / 4;
#pragma unroll
  for (int j = 0; j < CHUNK * PER_ROW / THREADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int i = e / PER_ROW, c = (e % PER_ROW) * 4;
    if (i < len && d0 + c < di)
      *reinterpret_cast<float4*>(y + (row + i) * di + d0 + c) =
          *reinterpret_cast<const float4*>(sy + i * BD + c);
  }
}

// Issue the copies of `len` time steps from row `row` (= b * S + t0) on
// into a ring stage. VEC: 16-byte copies (di % 4 == 0, operands aligned).
template <int N, bool VEC>
__device__ __forceinline__ void load_chunk(
    float* stage, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm, size_t row,
    int len, int d0, int di) {
  float* su = stage;
  float* sdt = su + CHUNK * BD;
  float* sB = sdt + CHUNK * BD;
  float* sC = sB + CHUNK * N;
  constexpr int W = VEC ? 4 : 1;      // floats a copy
  constexpr int PER_ROW = BD / W;
  constexpr int COPIES = CHUNK * PER_ROW / THREADS;   // a thread's, each
  static_assert(CHUNK * PER_ROW % THREADS == 0, "copies a thread");
  const auto copy = [&](int j) {
    const int e = threadIdx.x + j * THREADS;
    const int i = e / PER_ROW, c = (e % PER_ROW) * W;
    if (i < len && d0 + c < di) {
      const size_t off = (row + i) * di + d0 + c;
      cp_async<4 * W>(su + i * BD + c, u + off);
      cp_async<4 * W>(sdt + i * BD + c, dt + off);
    }
  };
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < COPIES; ++j) copy(j);
  } else {                  // 4 times the copies: a loop keeps 0 spills
#pragma unroll 1
    for (int j = 0; j < COPIES; ++j) copy(j);
  }
  for (int e = threadIdx.x; e < len * N / W; e += THREADS) {
    cp_async<4 * W>(sB + e * W, Bm + row * N + e * W);
    cp_async<4 * W>(sC + e * W, Cm + row * N + e * W);
  }
}

template <int N, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ Dv,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int S, int di) {
  constexpr int NL = N / LANES;       // states a lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int c = threadIdx.x / LANES, q = threadIdx.x % LANES;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * BD;
  const int d = d0 + c;
  const bool valid = d < di;
  const size_t hrow = ((size_t)b * di + d) * N + q * NL;

  float a2[NL], h[NL];
  float dskip = 0.f;
#pragma unroll
  for (int n = 0; n < NL; ++n) a2[n] = h[n] = 0.f;
  if (valid) {
    load<NL>(a2, A + (size_t)d * N + q * NL);
#pragma unroll
    for (int n = 0; n < NL; ++n) a2[n] *= A_SCALE;
    if (h0 != nullptr) load<NL>(h, h0 + hrow);
    dskip = Dv[d];
  }

  const size_t row0 = (size_t)b * S;           // row of (b, t = 0)
  const int chunks = (S + CHUNK - 1) / CHUNK;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks)
      load_chunk<N, VEC>(smem + k * stage_floats<N>(), u, dt, Bm, Cm,
                         row0 + k * CHUNK, min(CHUNK, S - k * CHUNK), d0, di);
    cp_async_commit();                         // empty groups keep the count
  }
  constexpr bool SY = STAGE_Y && VEC;
  float* sy = smem + STAGES * stage_floats<N>();   // 2 x [CHUNK][BD] if SY
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();               // this thread's copies of k
    __syncthreads();                           // everyone's; k - 1 consumed
    const int kn = k + STAGES - 1;
    if (kn < chunks)
      load_chunk<N, VEC>(smem + (kn % STAGES) * stage_floats<N>(), u, dt, Bm,
                         Cm, row0 + (size_t)kn * CHUNK,
                         min(CHUNK, S - kn * CHUNK), d0, di);
    cp_async_commit();
    if (SY && k > 0)
      flush_y(sy + ((k - 1) % 2) * CHUNK * BD, y, row0 + (k - 1) * CHUNK,
              CHUNK, d0, di);
    const float* su = smem + (k % STAGES) * stage_floats<N>();
    const float* sdt = su + CHUNK * BD;
    const float* sB = sdt + CHUNK * BD;
    const float* sC = sB + CHUNK * N;
    const int t0 = k * CHUNK, len = min(CHUNK, S - t0);
    float* y_row = y + (row0 + t0) * di + d;
#pragma unroll 2
    for (int i = 0; i < len; ++i) {
      const float uu = su[i * BD + c], dd = sdt[i * BD + c];
      const float du = dd * uu;
      float bv[NL], cv[NL];
      load<NL>(bv, sB + i * N + q * NL);
      load<NL>(cv, sC + i * N + q * NL);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        const float dA = scan_exp(dd * a2[n]);
        h[n] = fmaf(dA, h[n], du * bv[n]);
        acc[n % 4] = fmaf(h[n], cv[n], acc[n % 4]);
      }
      float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (SY) {
        if (q == 0) sy[(k % 2) * CHUNK * BD + i * BD + c] = fmaf(dskip, uu, s);
      } else if (valid && q == 0) {
        y_row[(size_t)i * di] = fmaf(dskip, uu, s);
      }
    }
  }
  if (SY && chunks > 0) {
    __syncthreads();
    const int k = chunks - 1;
    flush_y(sy + (k % 2) * CHUNK * BD, y, row0 + k * CHUNK,
            S - k * CHUNK, d0, di);
  }
  if (valid) store<NL>(h_out + hrow, h);
}

// One step (S == 1): N / 4 lanes a channel, 4 states each.
template <int N>
__global__ void __launch_bounds__(STEP_THREADS)
ssm_scan_step_kernel(const float* __restrict__ u,
                     const float* __restrict__ dt,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ A,
                     const float* __restrict__ Dv,
                     const float* __restrict__ h0, float* __restrict__ y,
                     float* __restrict__ h_out, int Bsz, int di) {
  constexpr int Q = N / 4;
  const size_t g = (size_t)blockIdx.x * STEP_THREADS + threadIdx.x;
  const size_t ch = g / Q;                     // b * di + d
  const int q = g % Q;
  const bool valid = ch < (size_t)Bsz * di;
  float a2[4] = {0.f, 0.f, 0.f, 0.f}, h[4] = {0.f, 0.f, 0.f, 0.f};
  float bv[4] = {0.f, 0.f, 0.f, 0.f}, cv[4] = {0.f, 0.f, 0.f, 0.f};
  float uu = 0.f, dd = 0.f, dskip = 0.f;
  if (valid) {
    const size_t b = ch / di, d = ch - b * di;
    load<4>(a2, A + d * N + 4 * q);
    if (h0 != nullptr) load<4>(h, h0 + ch * N + 4 * q);
#pragma unroll
    for (int n = 0; n < 4; ++n) {             // B and C rows: any alignment
      bv[n] = Bm[b * N + 4 * q + n];
      cv[n] = Cm[b * N + 4 * q + n];
    }
    uu = u[ch];
    dd = dt[ch];
    dskip = Dv[d];
  }
  const float du = dd * uu;
  float acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float dA = scan_exp(dd * (a2[n] * A_SCALE));
    h[n] = fmaf(dA, h[n], du * bv[n]);
    acc[n] = h[n] * cv[n];
  }
  float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int o = 1; o < Q; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (valid) {
    store<4>(h_out + ch * N + 4 * q, h);
    if (q == 0) y[ch] = fmaf(dskip, uu, s);
  }
}

template <int N, bool VEC>
cudaError_t configure() {
  static bool configured = false;
  return hopper::allow_smem(ssm_scan_kernel<N, VEC>, smem_bytes<N>(),
                            configured);
}

template <int N, bool VEC>
cudaError_t launch_scan(const float* u, const float* dt, const float* Bm,
                        const float* Cm, const float* A, const float* D,
                        const float* h0, float* y, float* h_out, int B,
                        int S, int di, cudaStream_t stream) {
  const cudaError_t e = configure<N, VEC>();
  if (e) return e;
  const dim3 grid((di + BD - 1) / BD, B);
  ssm_scan_kernel<N, VEC><<<grid, THREADS, smem_bytes<N>(), stream>>>(
      u, dt, Bm, Cm, A, D, h0, y, h_out, S, di);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int N>
cudaError_t launch(const void* u_, const void* dt_, const void* Bm_,
                   const void* Cm_, const void* A_, const void* D_,
                   const void* h0_, void* y_, void* h_out_, int B, int S,
                   int di, cudaStream_t stream) {
  const float* u = static_cast<const float*>(u_);
  const float* dt = static_cast<const float*>(dt_);
  const float* Bm = static_cast<const float*>(Bm_);
  const float* Cm = static_cast<const float*>(Cm_);
  const float* A = static_cast<const float*>(A_);
  const float* D = static_cast<const float*>(D_);
  const float* h0 = static_cast<const float*>(h0_);
  float* y = static_cast<float*>(y_);
  float* h_out = static_cast<float*>(h_out_);
  if (S == 1) {
    const size_t threads = (size_t)B * di * (N / 4);
    const size_t blocks = (threads + STEP_THREADS - 1) / STEP_THREADS;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    ssm_scan_step_kernel<N><<<(unsigned)blocks, STEP_THREADS, 0, stream>>>(
        u, dt, Bm, Cm, A, D, h0, y, h_out, B, di);
    return cudaGetLastError();
  }
  const bool vec = di % 4 == 0 && aligned16(u) && aligned16(dt) &&
                   aligned16(Bm) && aligned16(Cm);
  return vec ? launch_scan<N, true>(u, dt, Bm, Cm, A, D, h0, y, h_out, B, S,
                                    di, stream)
             : launch_scan<N, false>(u, dt, Bm, Cm, A, D, h0, y, h_out, B,
                                     S, di, stream);
}

template <int N>
int resident_blocks() {
  if (configure<N, true>()) return -1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ssm_scan_kernel<N, true>, THREADS, smem_bytes<N>());
  return e ? -(int)e : n;
}

}  // namespace

// Instantiated for the registered configs' d_state (jamba-v0.1-52b: 16;
// its `reduced()` test config: 4). h0 may be null: the scan then starts
// from a zero state and reads no h0. A and h0 must be 16-byte aligned.
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* Bm,
                            const void* Cm, const void* A, const void* D,
                            const void* h0, void* y, void* h_out, int B,
                            int S, int di, int N, void* stream) {
  if (B <= 0 || S < 0 || di <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(u, dt, Bm, Cm, A, D, h0, y, h_out, B, S, di, s);
    case 16: return launch<16>(u, dt, Bm, Cm, A, D, h0, y, h_out, B, S, di, s);
    default: return cudaErrorInvalidValue;
  }
}

// The prefill kernel's layout for d_state N: out[0..6] = time steps a
// chunk, ring stages, lanes a channel, channels a block, threads a block,
// dynamic shared memory bytes a block, and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on an error).
extern "C" int ssm_scan_layout(int N, int* out) {
  if (N != 4 && N != 16) return cudaErrorInvalidValue;
  out[0] = CHUNK;
  out[1] = STAGES;
  out[2] = LANES;
  out[3] = BD;
  out[4] = THREADS;
  out[5] = N == 4 ? smem_bytes<4>() : smem_bytes<16>();
  out[6] = N == 4 ? resident_blocks<4>() : resident_blocks<16>();
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
