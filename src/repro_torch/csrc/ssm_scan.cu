// Mamba selective scan for Hopper (sm_90a), fp32 in and out.
//
// Replaces: the Pallas TPU kernel `ssm_scan_kernel` (`_scan_kernel`) in
// src/repro/kernels/ssm_scan/kernel.py. For each sequence b and channel d,
// with an N-wide state h (fp32) that starts at h0[b, d] (or at zero):
//     h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//     y_t = h_t . C_t + D[d] * u_t
// u, dt, y are (B, S, di), B and C (B, S, N), A (di, N), D (di,), h0 and
// h_final (B, di, N), all row-major fp32. Any S and di: the TPU kernel's
// divisibility assert is gone.
//
// What bounds it on this card: at the served prefill shape (B 8, S 512,
// di 8192, N 16) the B*S*di*N exponentials, one MUFU.EX2 each at 16 per
// clock per SM (0.13 ms), just ahead of device-memory bytes (u, dt and y
// once each, 0.12 ms) and well ahead of the fp32 FMAs (~6 operations per
// state element, 0.05 ms at 67 TFLOP/s). At decode (S 1) the h0 read and
// the h_final write dominate the bytes, and a launch is pure latency.
//
// What the design does: the recurrence is sequential in t but independent
// across (b, d), so one thread owns one (b, d) and keeps its N states and
// its row of A in registers for the whole sequence; the TPU kernel's
// sequential chunk axis, which carried h in VMEM scratch, becomes the loop
// inside the thread. A block covers 128 consecutive channels of one b, so
// the loads of u_t and dt_t and the stores of y_t are coalesced (di is
// contiguous). Time advances in chunks of 32 steps: the block first stages
// the chunk's u and dt (each thread its own column, all loads in flight
// together) and its B and C rows (shared by every channel; read back as
// broadcasts) in shared memory, then runs the 32 steps from there. h0 is
// read and h_final written once. expf, not __expf: the card agrees with
// the plain version to a relative gate, not bit for bit, because nvcc
// contracts a * h + b into one FMA. Not done yet: a thread per (b, d) gives
// 64 K threads at the served shapes, a quarter of the 270 K the card holds
// at once; splitting N across a few lanes (and reducing y with shuffles)
// would fill it.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_D = 128;   // channels per block, one thread each
constexpr int CHUNK = 32;      // time steps staged in shared memory

template <int N>
__global__ void __launch_bounds__(BLOCK_D)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ Dv,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int S, int di) {
  __shared__ float s_u[CHUNK][BLOCK_D];
  __shared__ float s_dt[CHUNK][BLOCK_D];
  __shared__ float s_B[CHUNK][N];
  __shared__ float s_C[CHUNK][N];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * BLOCK_D + tid;
  const bool valid = d < di;

  float a[N], h[N];
  float dskip = 0.f;
  if (valid) {
    const float4* a4 = reinterpret_cast<const float4*>(A + (size_t)d * N);
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
      const float4 v = a4[n];
      a[4 * n] = v.x; a[4 * n + 1] = v.y; a[4 * n + 2] = v.z;
      a[4 * n + 3] = v.w;
    }
    if (h0 != nullptr) {
      const float4* h4 =
          reinterpret_cast<const float4*>(h0 + ((size_t)b * di + d) * N);
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
        const float4 v = h4[n];
        h[4 * n] = v.x; h[4 * n + 1] = v.y; h[4 * n + 2] = v.z;
        h[4 * n + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = 0.f;
    }
    dskip = Dv[d];
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) a[n] = h[n] = 0.f;
  }

  const size_t row0 = (size_t)b * S;           // row of (b, t = 0)
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int len = min(CHUNK, S - t0);
    __syncthreads();                           // the last chunk is consumed
    if (valid) {
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        const size_t off = (row0 + t0 + i) * di + d;
        s_u[i][tid] = u[off];
        s_dt[i][tid] = dt[off];
      }
    }
    const float* b_src = Bm + (row0 + t0) * N;  // len * N contiguous floats
    const float* c_src = Cm + (row0 + t0) * N;
    for (int e = tid; e < len * N; e += BLOCK_D) {
      s_B[e / N][e % N] = b_src[e];
      s_C[e / N][e % N] = c_src[e];
    }
    __syncthreads();
    if (valid) {
      float* y_row = y + (row0 + t0) * di + d;
      for (int i = 0; i < len; ++i) {
        const float uu = s_u[i][tid];
        const float dd = s_dt[i][tid];
        const float du = dd * uu;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float dA = expf(dd * a[n]);
          h[n] = dA * h[n] + du * s_B[i][n];
          acc += h[n] * s_C[i][n];
        }
        y_row[(size_t)i * di] = acc + dskip * uu;
      }
    }
  }

  if (valid) {
    float4* o4 = reinterpret_cast<float4*>(h_out + ((size_t)b * di + d) * N);
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
      o4[n] = make_float4(h[4 * n], h[4 * n + 1], h[4 * n + 2], h[4 * n + 3]);
  }
}

template <int N>
cudaError_t launch(const void* u, const void* dt, const void* Bm,
                   const void* Cm, const void* A, const void* D,
                   const void* h0, void* y, void* h_out, int B, int S,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + BLOCK_D - 1) / BLOCK_D, B);
  ssm_scan_kernel<N><<<grid, BLOCK_D, 0, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, di);
  return cudaGetLastError();
}

}  // namespace

// Instantiated for the registered configs' d_state (jamba-v0.1-52b: 16;
// its `reduced()` test config: 4). h0 may be null: the scan then starts
// from a zero state and reads no h0.
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

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
