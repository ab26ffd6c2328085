// int8 x int8 -> int32 GEMM with fused dequantization for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `int8_matmul_kernel` (`_mm_kernel`) in
// src/repro/kernels/int8_matmul/kernel.py. out[m, n] = (float)acc[m, n] *
// (x_scale * w_scale[n]), where acc is the exact int32 sum over all of K
// of x_q[m, k] * w_q[k, n]; the product of the two scales is taken first,
// and the one conversion and the one multiply happen once, in the
// epilogue, so the result equals its plain version bit for bit. x_q is
// (M, K) row-major, w_q (K, N) row-major (the reference's layout), out
// (M, N) fp32. K must be a multiple of 16 and N of 8 (the loads' widths);
// any M. Rows past M, columns past N and K past the last tile are loaded
// as zero and never stored, so the TPU kernel's divisibility assert is
// gone.
//
// What bounds it on this card: at the decode shapes (M = 8) device-memory
// bytes, the K x N weight read once: 2 M ops per weight byte against the
// ~590 int8 ops per byte at which the tensor cores (1,979 TOP/s) would
// bound. At the prefill shapes (M = 8 * 512) the tensor cores.
//
// What the design does: integer tensor cores through
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`, int32 accumulators in
// registers. That instruction wants K contiguous in both operands, and
// `ldmatrix.trans` moves 16-bit elements, not bytes, so the (K, N) weight
// tile is transposed on its way into shared memory: each thread loads a
// 4 (k) x 8 (n) block, four 8-byte row pieces, and a byte permute turns it
// into eight 4-byte words of 4 consecutive k for one n. Shared rows are
// padded by 16 bytes so that the fragment loads are free of bank
// conflicts. Tiles are double-buffered through registers: the next tile's
// global loads are in flight while the current one feeds the tensor cores.
// Two tile shapes: 16 x 32 x 256 for M <= 16 (decode and the prefill
// lm_head), so a block streams a narrow, deep slice of the weight, and
// 128 x 128 x 64 otherwise. Not done yet: wgmma and TMA, and a split-K for
// M = 8, where N / 32 blocks under-fill the 132 SMs at the narrow
// projections.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <int BM_, int BN_, int BK_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;    // mma tiles per warp
  static constexpr int LDS = BK + 16;                // padded row, bytes
  static constexpr int A_CHUNKS = BM * BK / 16;      // 16-byte pieces
  static constexpr int B_CHUNKS = (BK / 4) * (BN / 8);  // 4 x 8 blocks
  static constexpr int A_PER = (A_CHUNKS + THREADS - 1) / THREADS;
  static constexpr int B_PER = B_CHUNKS / THREADS;
  static constexpr int STAGE = (BM + BN) * LDS;      // bytes per buffer
  static constexpr int SMEM = 2 * STAGE;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && BK % 32 == 0, "tile");
  static_assert(B_CHUNKS % THREADS == 0, "B chunks per thread");
  static_assert(SMEM <= 48 * 1024, "static launch needs <= 48 KB");
};

using Small = Tile<16, 32, 256, 1, 4>;    // M <= 16
using Large = Tile<128, 128, 64, 2, 4>;   // M > 16

__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// r[kk] holds bytes n0..n0+3 of row k0+kk; returns in t[j] the bytes
// k0..k0+3 of column n0+j (a 4 x 4 byte transpose).
__device__ inline void transpose4x4(const uint32_t (&r)[4], uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t x1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t y0 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t y1 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(x0, x1, 0x5410);
  t[1] = __byte_perm(x0, x1, 0x7632);
  t[2] = __byte_perm(y0, y1, 0x5410);
  t[3] = __byte_perm(y0, y1, 0x7632);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale, float* __restrict__ out,
                   int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int g = lane / 4, t4 = lane % 4;            // mma fragment coords
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;

  uint4 ra[T::A_PER];
  uint2 rb[T::B_PER][4];

  // Global -> registers: A as 16-byte row pieces; B as 4 (k) x 8 (n)
  // blocks, k-quad fastest across threads so the transposed stores of a
  // warp fall in distinct banks.
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int c = tid + i * T::THREADS;
      const int r = c / (T::BK / 16), kc = (c % (T::BK / 16)) * 16;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (c < T::A_CHUNKS && m0 + r < M && k0 + kc < K)
        ra[i] = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + k0 + kc);
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int c = tid + i * T::THREADS;
      const int kq = c % (T::BK / 4), nq = c / (T::BK / 4);
      const int n = n0 + nq * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = k0 + kq * 4 + kk;
        rb[i][kk] = make_uint2(0, 0);
        if (k < K && n < N)
          rb[i][kk] = *reinterpret_cast<const uint2*>(w + (size_t)k * N + n);
      }
    }
  };

  // Registers -> shared: A as it is, B transposed to (n, k).
  auto store = [&](int buf) {
    unsigned char* As = smem + buf * T::STAGE;
    unsigned char* Bs = As + T::BM * T::LDS;
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::A_CHUNKS) {
        const int r = c / (T::BK / 16), kc = (c % (T::BK / 16)) * 16;
        *reinterpret_cast<uint4*>(As + r * T::LDS + kc) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int c = tid + i * T::THREADS;
      const int kq = c % (T::BK / 4), nq = c / (T::BK / 4);
      const uint32_t lo[4] = {rb[i][0].x, rb[i][1].x, rb[i][2].x, rb[i][3].x};
      const uint32_t hi[4] = {rb[i][0].y, rb[i][1].y, rb[i][2].y, rb[i][3].y};
      uint32_t t[4];
      transpose4x4(lo, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(Bs + (nq * 8 + j) * T::LDS + kq * 4) =
            t[j];
      transpose4x4(hi, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(Bs + (nq * 8 + 4 + j) * T::LDS +
                                     kq * 4) = t[j];
    }
  };

  int acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  auto compute = [&](int buf) {
    const unsigned char* As = smem + buf * T::STAGE;
    const unsigned char* Bs = As + T::BM * T::LDS;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 32) {
      uint32_t a[T::MI][4], b[T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        const unsigned char* p = As + (wm * T::TM + mi * 16 + g) * T::LDS +
                                 kk + t4 * 4;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * T::LDS);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * T::LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const unsigned char* p = Bs + (wn * T::TN + ni * 8 + g) * T::LDS +
                                 kk + t4 * 4;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  };

  const int nk = (K + T::BK - 1) / T::BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * T::BK);
    compute(kt & 1);
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  // Epilogue: one int -> float conversion and one multiply by
  // (x_scale * w_scale[n]), as the plain version does them.
  const float xs = *x_scale;
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) {
    const int n = n0 + wn * T::TN + ni * 8 + t4 * 2;
    if (n >= N) continue;                  // N is even: n + 1 < N too
    const float s0 = __fmul_rn(xs, w_scale[n]);
    const float s1 = __fmul_rn(xs, w_scale[n + 1]);
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * T::TM + mi * 16 + g + h * 8;
        if (m < M) {
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), s0),
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), s1));
        }
      }
    }
  }
}

template <class T>
cudaError_t launch(const void* x, const void* w, const void* xs,
                   const void* ws, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  int8_matmul_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_matmul_s8(const void* x, const void* w,
                              const void* x_scale, const void* w_scale,
                              void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M <= Small::BM ? launch<Small>(x, w, x_scale, w_scale, out, M, N, K, s)
                        : launch<Large>(x, w, x_scale, w_scale, out, M, N, K, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
