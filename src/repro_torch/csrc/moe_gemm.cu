// Grouped GEMM over int8 MoE experts, the weights dequantized in registers,
// for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The reference's MoE (src/repro/models/moe.py,
// `apply_moe`) dequantizes its stacked int8 expert weights to bf16
// (`q.astype(bf16) * scale.astype(bf16)`) and leaves the three batched
// expert products to XLA; the port did the same in plain PyTorch
// (`models.moe._w`, then an einsum), which wrote and read a bf16 copy of
// every expert on every call. This kernel computes
//
//   out[e, m, n] = bf16(sum_k x[e, m, k] w[e, k, n]),
//   w[e, k, n] = bf16(bf16(q[e, k, n]) * bf16(scale[e, 0, n]))
//
// with x (E, M, K) bf16, q (E, K, N) int8 row-major (as
// `quant.quantize_weight` stores a stack of experts), scale (E, 1, N) fp32
// and out (E, M, N) bf16, all contiguous. Each weight is formed in
// registers with the bits `quant.dequantize` gives it, the products run on
// the tensor cores in bf16 with fp32 sums, rounded once to bf16: the
// einsum's arithmetic, summed in another order. No bf16 weight is ever
// written to device memory, and every expert's M rows are computed, as
// the einsum computes them.
//
// What bounds it on this card: at the decode shapes (M of 1 to 8 rows an
// expert) the int8 weight, read once: 2 M operations per weight byte
// against the ~295 at which the bf16 tensor cores would bound. At the
// prefill shapes (M up to 1280) the tensor cores.
//
// What the design does. The weight is the A operand of wgmma, in
// registers, and the rows of x are B (K-major, from shared memory), so the
// products are out^T = w^T x^T and the few decode rows sit on wgmma's
// narrow N side (8 to 256 rows a tile, zero rows past M). A block owns BN
// output columns of one expert and one tile of rows, and walks K in
// stages of 64: one thread issues the TMA copies of the stage's int8
// weight tile (128 columns x 64 k-rows a box, 128-byte swizzle) and x
// tile into a ring with a "full" and an "empty" mbarrier a stage. Each
// consumer warpgroup owns one or two 64-column sub-tiles. A warp reads its
// 16 columns x 32 k-rows of a sub-tile (16 where two sub-tiles of 128 sums
// leave few registers) with one ldmatrix .trans (16-bit elements = column
// pairs), which leaves each thread the bytes (k, n), (k, n + 1), (k + 1,
// n), (k + 1, n + 1): A's row r is column n and row r + 8 column n + 1,
// so the even bytes and the odd ones are the two registers wgmma wants.
// The int8 -> bf16 conversion is exact without I2F: a code's low 7 bits
// under the exponent of 128 make the bf16 128 + (c & 127), its sign bit
// under it 128 or 256, and their difference is c (two LOP3 and one bf16x2
// subtract for two codes); one bf16x2 multiply by the column's bf16 scale
// rounds as `dequantize` does. The chunks' registers alternate, so a
// chunk's conversion runs while the previous chunk's products are in
// flight.
//  - Decode (M <= 64): one consumer warpgroup (two sub-tiles) and one
//    producer warp, 128 columns a block; the grid is (1, N / 128, E), 4-8
//    stages and 3 blocks an SM (72 KB of ring each), so the SMs keep ~200
//    KB of weight in flight.
//  - Prefill (M > 64): two consumer warpgroups and a producer warpgroup
//    that gives them its registers. 256 rows x 128 columns a block (each
//    consumer one sub-tile, 128 fp32 sums a thread), 4 stages of 40 KB;
//    where 128-row tiles pad fewer rows (qwen3-30b-a3b's 320), 128 rows x
//    256 columns (two sub-tiles a consumer), 6 stages of 32 KB. A weight
//    is converted once a row tile, so the taller tile halves the
//    conversions (22% faster at mixtral's 1280 rows on an H100). The
//    grid walks the row tiles first, so the blocks in flight share
//    weight tiles and an expert's x stays in L2.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

template <int RN>
struct Tile {
  static constexpr bool WIDE = RN > 64;         // the prefill shape
  static constexpr int NC = WIDE ? 2 : 1;       // consumer warpgroups
  // 64-column sub-tiles a consumer: two, one where 256 rows take its
  // registers
  static constexpr int TM = RN > 128 ? 1 : 2;
  static constexpr int BN = NC * TM * 64;       // output columns a block
  static constexpr int BK = 64;                 // k-rows a stage
  // k-rows a chunk, whose fragments alternate with the next one's: 16
  // where two sub-tiles of 128 fp32 sums leave few registers
  static constexpr int CK = RN == 128 ? 16 : 32;
  static constexpr int W_BOX = BK * 128;        // 128 columns x BK, int8
  static constexpr int W_TILE = BN / 128 * W_BOX;
  static constexpr int X_TILE = RN * 128;       // RN rows x 64 bf16
  static constexpr int STAGE = W_TILE + X_TILE;
  // the ring: 192 KB at prefill (one block an SM), 72 KB at decode
  static constexpr int STAGES = (WIDE ? 196608 : 73728) / STAGE;
  static constexpr int THREADS = NC * 128 + (WIDE ? 128 : 32);
  // blocks an SM: the decode ring (72 KB) fits three, and a thread's
  // registers must leave room for them
  static constexpr int MIN_BLOCKS = WIDE ? 1 : RN <= 32 ? 3 : 2;
  static constexpr int OFF_BAR = STAGES * STAGE;
  static constexpr size_t SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
};

struct Shape {
  int M, N, nkt;                     // rows, columns, k stages
};

template <int RN>
__device__ __forceinline__ void wgmma_rn(float (&d)[RN / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (RN == 8)
    hopper::wgmma_m64n8k16_rs<0>(d, a[0], a[1], a[2], a[3], b, 1);
  else if constexpr (RN == 16)
    hopper::wgmma_m64n16k16_rs<0>(d, a[0], a[1], a[2], a[3], b, 1);
  else if constexpr (RN == 32)
    hopper::wgmma_m64n32k16_rs<0>(d, a[0], a[1], a[2], a[3], b, 1);
  else if constexpr (RN == 64)
    hopper::wgmma_m64n64k16_rs<0>(d, a[0], a[1], a[2], a[3], b, 1);
  else if constexpr (RN == 128)
    hopper::wgmma_m64n128k16_rs<0>(d, a[0], a[1], a[2], a[3], b, 1);
  else
    hopper::wgmma_m64n256k16_rs<0>(d, a[0], a[1], a[2], a[3], b, 1);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The int8 codes in bytes 0 and 2 of v as two bf16, exactly: 0x4300 | (c &
// 0x7f) is 128 + (c & 127), 0x4300 | (c & 0x80) is 128 or 256 (the sign
// bit lands on the exponent's lowest bit), and their difference is c.
__device__ __forceinline__ uint32_t codes_02(uint32_t v) {
  return bf16x2_sub((v & 0x007F007Fu) | 0x43004300u,
                    (v & 0x00800080u) | 0x43004300u);
}

// An ldmatrix .trans word, bytes (k, n), (k, n + 1), (k + 1, n), (k + 1,
// n + 1), as A's two registers: lo = column n at k, k + 1 times s_n, hi =
// column n + 1 times s_n1 (s a bf16 pair of one scale). bf16(c) * bf16(s)
// is exact in fp32, so mul.rn rounds it as `dequantize`'s fp32 product
// rounded to bf16 does.
__device__ __forceinline__ void dequant(uint32_t v, uint32_t s_n,
                                        uint32_t s_n1, uint32_t& lo,
                                        uint32_t& hi) {
  lo = bf16x2_mul(codes_02(v), s_n);
  hi = bf16x2_mul(codes_02(__byte_perm(v, 0, 0x3311)), s_n1);
}

// A of one chunk (CK k-rows, CK / 16 k16 steps) of this thread's TM
// sub-tiles
template <int RN>
using Frag = uint32_t[Tile<RN>::TM][Tile<RN>::CK / 16][4];

// The A fragments of chunk q of a stage (k-rows CK q ..): for each
// sub-tile st the warp's 16 columns (its 128-column box st / 2, 16-byte
// chunk 4 (st % 2) + w of each swizzled 128-byte k-row), one ldmatrix of
// 8 k-rows a matrix (thread `lane` gives the address of k-row CK q + lane
// % CK).
template <int RN>
__device__ __forceinline__ void load_a(const uint8_t* wt,
                                       const uint32_t (&sc)[2][2], int st0,
                                       int w, int lane, int q, Frag<RN>& a) {
  using T = Tile<RN>;
  const int kr = T::CK * q + lane % T::CK;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int st = st0 + i, chunk = 4 * (st % 2) + w;
    const uint8_t* p =
        wt + (st / 2) * T::W_BOX + kr * 128 + ((chunk ^ (kr & 7)) << 4);
    uint32_t r[T::CK / 8];
    if constexpr (T::CK == 32)
      hopper::ldmatrix_x4_trans(r, p);
    else
      hopper::ldmatrix_x2_trans(r, p);
#pragma unroll
    for (int j = 0; j < T::CK / 16; ++j) {
      dequant(r[2 * j], sc[i][0], sc[i][1], a[i][j][0], a[i][j][1]);
      dequant(r[2 * j + 1], sc[i][0], sc[i][1], a[i][j][2], a[i][j][3]);
    }
  }
}

template <int RN>
__device__ __forceinline__ void fence_frag(Frag<RN>& a) {
#pragma unroll
  for (int i = 0; i < Tile<RN>::TM; ++i)
#pragma unroll
    for (int j = 0; j < Tile<RN>::CK / 16; ++j)
      hopper::fence_operands(a[i][j]);
}

template <int RN>
__device__ __forceinline__ void fence_acc(float (&acc)[Tile<RN>::TM][RN / 2]) {
#pragma unroll
  for (int i = 0; i < Tile<RN>::TM; ++i) hopper::fence_operands(acc[i]);
}

// Converts chunk q of the stage at `wt` into `a` and issues its products
// (x's k16 steps from the descriptor dx), then waits for the products
// issued before them, which read `prev`.
template <int RN>
__device__ __forceinline__ void chunk(const uint8_t* wt, uint64_t dx,
                                      const uint32_t (&sc)[2][2], int st0,
                                      int w, int lane, int q,
                                      float (&acc)[Tile<RN>::TM][RN / 2],
                                      Frag<RN>& a, Frag<RN>& prev) {
  load_a<RN>(wt, sc, st0, w, lane, q, a);
  fence_acc<RN>(acc);
  fence_frag<RN>(a);
  hopper::wgmma_fence();
  constexpr int STEPS = Tile<RN>::CK / 16;
#pragma unroll
  for (int j = 0; j < STEPS; ++j)
#pragma unroll
    for (int i = 0; i < Tile<RN>::TM; ++i)
      wgmma_rn<RN>(acc[i], a[i][j],
                   hopper::desc_advance(dx, 32 * (STEPS * q + j)));
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
  fence_acc<RN>(acc);
  fence_frag<RN>(prev);
}

// One stage (BK / CK chunks, an even count: their fragments a0, a1, a0,
// ...): once its first chunk's products are issued, the previous stage's
// are done and its tiles go back to the producer.
template <int RN>
__device__ __forceinline__ void stage(uint8_t* smem, uint64_t* full,
                                      uint64_t* empty, int it,
                                      const uint32_t (&sc)[2][2], int st0,
                                      int w, int lane,
                                      float (&acc)[Tile<RN>::TM][RN / 2],
                                      Frag<RN>& a0, Frag<RN>& a1) {
  using T = Tile<RN>;
  static_assert(T::BK / T::CK % 2 == 0, "an even count of chunks a stage");
  const int s = it % T::STAGES;
  const uint8_t* wt = smem + s * T::STAGE;
  const uint64_t dx = hopper::desc_sw128(wt + T::W_TILE, 16, 1024);
  hopper::mbar_wait(&full[s], (it / T::STAGES) & 1);
  chunk<RN>(wt, dx, sc, st0, w, lane, 0, acc, a0, a1);
  if (it > 0) hopper::mbar_arrive(&empty[(it - 1) % T::STAGES]);
  chunk<RN>(wt, dx, sc, st0, w, lane, 1, acc, a1, a0);
#pragma unroll
  for (int q = 2; q < T::BK / T::CK; q += 2) {
    chunk<RN>(wt, dx, sc, st0, w, lane, q, acc, a0, a1);
    chunk<RN>(wt, dx, sc, st0, w, lane, q + 1, acc, a1, a0);
  }
}

template <int RN>
__global__ void __launch_bounds__(Tile<RN>::THREADS, Tile<RN>::MIN_BLOCKS)
moe_w8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, const Shape sh) {
  using T = Tile<RN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - hopper::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  uint64_t* empty = full + T::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], T::NC * 128);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int m0 = blockIdx.x * RN, n_blk = blockIdx.y * T::BN;
  const int e = blockIdx.z;
  if (threadIdx.x >= T::NC * 128) {          // producer
    if constexpr (T::WIDE) hopper::regs_dec<40>();
    if (threadIdx.x == T::NC * 128) {
      for (int it = 0; it < sh.nkt; ++it) {
        const int s = it % T::STAGES;
        if (it >= T::STAGES)
          hopper::mbar_wait(&empty[s], (it / T::STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], T::STAGE);
        uint8_t* st = smem + s * T::STAGE;
#pragma unroll
        for (int b = 0; b < T::BN / 128; ++b)
          hopper::tma_load_3d(st + b * T::W_BOX, &map_w, &full[s],
                              n_blk + 128 * b, it * T::BK, e);
        hopper::tma_load_3d(st + T::W_TILE, &map_x, &full[s], it * T::BK,
                            m0, e);
      }
    }
    return;
  }
  if constexpr (T::WIDE) hopper::regs_inc<232>();

  const int cw = threadIdx.x / 128, t = threadIdx.x % 128;
  const int w = t / 32, lane = t % 32, st0 = cw * T::TM;
  // the bf16 scales of this thread's columns n, n + 1 of each sub-tile,
  // each as a pair
  uint32_t sc[2][2];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_blk + 64 * (st0 + i) + 16 * w + 2 * (lane / 4) + h;
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(
          n < sh.N ? scale[(size_t)e * sh.N + n] : 0.f));
      sc[i][h] = b | (b << 16);
    }

  float acc[T::TM][RN / 2];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < RN / 2; ++j) acc[i][j] = 0.f;
  Frag<RN> a0, a1;
  for (int it = 0; it < sh.nkt; ++it)
    stage<RN>(smem, full, empty, it, sc, st0, w, lane, acc, a0, a1);
  hopper::wgmma_wait<0>();
  fence_acc<RN>(acc);
  fence_frag<RN>(a1);
  hopper::mbar_arrive(&empty[(sh.nkt - 1) % T::STAGES]);

  // acc[i][4 j + e] is A's row r + 8 (e / 2) of sub-tile i, i.e. column n +
  // e / 2, and x's row 8 j + 2 (lane % 4) + e % 2: a column pair a store
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int n = n_blk + 64 * (st0 + i) + 16 * w + 2 * (lane / 4);
    if (n >= sh.N) continue;
#pragma unroll
    for (int j = 0; j < RN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * (lane % 4) + h;
        if (m < sh.M)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((size_t)e * sh.M + m) * sh.N + n) =
              __floats2bfloat162_rn(acc[i][4 * j + h], acc[i][4 * j + 2 + h]);
      }
  }
}

template <int RN>
cudaError_t launch(const void* x, const void* q, const float* scale,
                   __nv_bfloat16* out, int E, int M, int K, int N,
                   cudaStream_t st) {
  using T = Tile<RN>;
  static bool configured = false;
  cudaError_t e =
      hopper::allow_smem(moe_w8_gemm_kernel<RN>, T::SMEM, configured);
  if (e) return e;
  CUtensorMap mx, mw;
  if ((e = hopper::tiled_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                             E, 64, RN)) ||
      (e = hopper::tiled_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, E,
                             128, T::BK)))
    return e;
  const Shape sh{M, N, (K + T::BK - 1) / T::BK};
  const dim3 grid((M + RN - 1) / RN, (N + T::BN - 1) / T::BN, E);
  moe_w8_gemm_kernel<RN><<<grid, T::THREADS, T::SMEM, st>>>(mx, mw, scale,
                                                           out, sh);
  return cudaGetLastError();
}

}  // namespace

// x (E, M, K) bf16, q (E, K, N) int8, scale (E, 1, N) fp32, out (E, M, N)
// bf16, all contiguous and 16-byte aligned; N a multiple of 128, K of 16.
// The rows' tile is chosen by M alone: 8, 16, 32 or 64 rows (decode), else
// 256, or 128 where that pads fewer rows (320 rows: 3 x 128, not 2 x 256).
extern "C" int moe_w8_gemm(const void* x, const void* q, const void* scale,
                           void* out, int E, int M, int K, int N,
                           void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0 || N % 128 || K % 16 ||
      E > 65535)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (M <= 8) return launch<8>(x, q, sc, o, E, M, K, N, s);
  if (M <= 16) return launch<16>(x, q, sc, o, E, M, K, N, s);
  if (M <= 32) return launch<32>(x, q, sc, o, E, M, K, N, s);
  if (M <= 64) return launch<64>(x, q, sc, o, E, M, K, N, s);
  // 256 rows a tile unless tiles of 128 pad fewer rows
  const long pad128 = (M + 127L) / 128 * 128, pad256 = (M + 255L) / 256 * 256;
  return pad256 <= pad128 ? launch<256>(x, q, sc, o, E, M, K, N, s)
                          : launch<128>(x, q, sc, o, E, M, K, N, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
