// int8 x int8 -> int32 GEMM with fused dequantization for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `int8_matmul_kernel` (`_mm_kernel`) in
// src/repro/kernels/int8_matmul/kernel.py. out[m, n] = (float)acc[m, n] *
// (x_scale * w_scale[n]), where acc is the exact int32 sum over all of K
// of x_q[m, k] * w_q[k, n]; the product of the two scales is taken first,
// and the one conversion and the one multiply happen once, in the
// epilogue, so the result equals its plain version bit for bit whatever
// the order of the sums. x_q is (M, K) with rows ldx bytes apart; w_q is
// the reference's (K, N) weight stored K-major, i.e. the first K columns of
// a row-major (N, ldw) array `wt` with w_q[k, n] = wt[n, k]; out is (M, N)
// fp32 with rows ldo floats apart. Any M, K and N: TMA needs only the row
// strides to be multiples of 16 bytes (ldx and ldw of 16, ldo of 4), so a
// ragged K or N (xlstm-350m's sLSTM projections, K or N 1365) lives in
// rows padded to those multiples, and the tensor maps describe the true K
// and N: TMA reads every element past K, and every row past M or N, as
// zero (a zero code adds zero to the int32 sum), and no row or column
// past M or N is stored.
//
// What bounds it on this card: at the decode shapes (M <= 64) the K x N
// weight's bytes, read once: 2 M operations per weight byte against the
// ~590 int8 operations per byte at which the tensor cores (1,979 TOP/s)
// would bound. At the prefill shapes (M = 8 x 512 rows) the tensor cores.
//
// What the design does. The integer wgmma (.s32.s8.s8) has no transpose:
// both operands must be K-major in shared memory, which is why the model
// stores its int8 weights K-major (one copy, the reference's (K, N) shape
// and values). Every tile arrives by TMA under the 128-byte swizzle, one
// 128-byte k-tile (128 int8 of K) per stage, into a ring of stages with a
// "full" mbarrier (the copies landed) and an "empty" one (the consumers
// are done) per stage; one thread issues the copies; int32 accumulators
// stay in registers until the epilogue.
//  - Prefill (M > 64): 128 x BN tiles of out (BN 256, or 128 where 128 x
//    256 tiles would not fill the 132 SMs), numbered with M fastest so
//    that the blocks in flight share weight tiles (each comes from device
//    memory once, x from L2), walked by a persistent grid of one block an
//    SM. Warpgroup 0 is the producer (it gives its registers to the
//    others, and fills the ring with the next tile's stages while the
//    consumers run an epilogue); warpgroups 1 and 2 own 64 rows each and
//    issue wgmma m64nBNk32 with x (64 x 32) as A and the weight tile (BN x
//    32, K-major) as B, 4 per stage, keeping one stage's products in
//    flight while they wait for the next. The epilogue stages the fp32
//    tile through shared memory in 64 x 32 chunks that TMA stores, so the
//    output's writes run on under the next tile's products.
//  - Decode (M <= 64): the roles swap, out^T = w^T x^T. The weight tile
//    (64 output columns x 32 of K, K-major) is A and x (M rows, K-major,
//    padded to MN = 8, 16, 32 or 64 rows) is B of wgmma m64nMNk32; one
//    consumer warpgroup and one producer warp a block, a 4-stage ring
//    (32 KB of weight in flight, 4-5 blocks an SM). Where N / 64 tiles do
//    not fill the SMs and K is long, K is split over a cluster of 2, 4 or
//    8 blocks along gridDim.y: each sums its K range in int32, the partial
//    sums meet in the first block's registers through distributed shared
//    memory, and only then are they converted and scaled, once.
#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128;                // bytes (int8) of K per stage
constexpr int SM_COUNT = 132;          // H100 SXM

// ---- prefill --------------------------------------------------------------

constexpr int P_BM = 128, P_STAGES = 4, P_THREADS = 384, P_CONSUMERS = 256;
constexpr bool PERSISTENT = true;      // one block an SM, walking tiles

// The epilogue stages out in chunks of 64 rows x 32 fp32 (one 128-byte
// swizzled row each), two buffers a consumer warpgroup.
constexpr int OUT_CHUNK = 64 * 32 * 4;

template <int BN>
struct Prefill {
  static constexpr int A_TILE = P_BM * BK;           // 16 KB
  static constexpr int STAGE = A_TILE + BN * BK;     // 48 or 32 KB
  static constexpr int OFF_OUT = P_STAGES * STAGE;
  static constexpr int OFF_BAR = OFF_OUT + 4 * OUT_CHUNK;
  static constexpr size_t SMEM = OFF_BAR + 2 * P_STAGES * 8 + 1024;
};

struct Shape {
  int M, N, nkt, tiles_m, tiles;       // k-tiles, M tiles, all tiles
};

struct Bars {
  uint64_t full[P_STAGES], empty[P_STAGES];
};

// The tiles are numbered with M fastest, so the blocks in flight share
// weight tiles; a block takes tiles blockIdx.x, + gridDim.x, ... Each role
// reads blockIdx.x after its register reallocation, from a volatile
// %ctaid.x (a value live across setmaxnreg is spilled by ptxas).
__device__ __forceinline__ int first_tile() {
  int id;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(id));
  return id;
}

template <int BN>
__device__ __forceinline__ int2 tile_origin(const Shape& sh, int tile) {
  return make_int2((tile % sh.tiles_m) * P_BM, (tile / sh.tiles_m) * BN);
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (BN == 256)
    hopper::wgmma_m64n256k32_s8(d, a, b, 1);
  else
    hopper::wgmma_m64n128k32_s8(d, a, b, 1);
}

template <int BN>
__device__ __forceinline__ void prefill_consume(
    uint8_t* smem, Bars* bars, const CUtensorMap* map_o,
    const float* __restrict__ x_scale, const float* __restrict__ w_scale,
    const Shape& sh) {
  using P = Prefill<BN>;
  const int cw = threadIdx.x / 128 - 1;       // consumer warpgroup, 0 or 1
  const int t = threadIdx.x % 128, lane = t % 32;
  const float xs = *x_scale;
  int it = 0;                                 // stages consumed so far
  for (int tile = first_tile(); tile < sh.tiles; tile += gridDim.x) {
    const int2 o = tile_origin<BN>(sh, tile);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int kt = 0; kt < sh.nkt; ++kt, ++it) {
      const int s = it % P_STAGES;
      const uint8_t* a = smem + s * P::STAGE + cw * 64 * BK;
      const uint8_t* b = smem + s * P::STAGE + P::A_TILE;
      hopper::mbar_wait(&bars->full[s], (it / P_STAGES) & 1);
      const uint64_t da = hopper::desc_sw128(a, 16, 1024);
      const uint64_t db = hopper::desc_sw128(b, 16, 1024);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_bn<BN>(acc, hopper::desc_advance(da, kk * 32),
                     hopper::desc_advance(db, kk * 32));
      hopper::wgmma_commit();
      // the previous stage's products are done: hand its tiles back
      hopper::wgmma_wait<1>();
      hopper::fence_operands(acc);
      if (kt > 0) hopper::mbar_arrive(&bars->empty[(it - 1) % P_STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    // the tile's last stage: the producer fills the ring with the next
    // tile's stages while this one's epilogue runs
    hopper::mbar_arrive(&bars->empty[(it - 1) % P_STAGES]);

    // The epilogue, 32 columns at a time: acc[4 j + e] is row r + 8 (e / 2),
    // column 8 j + 2 (t % 4) + e % 2. Each chunk goes into one of this
    // warpgroup's two buffers under the 128-byte swizzle (16-byte piece p
    // of row rr at piece p ^ (rr % 8)), and one thread stores it with TMA,
    // which clips rows past M and columns past N; the store runs on while
    // the next chunk is written and, after the last, while the next
    // tile's products run.
    uint8_t* bufs = smem + P::OFF_OUT + cw * 2 * OUT_CHUNK;
    const int r = 16 * (t / 32) + lane / 4;
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      uint8_t* buf = bufs + (c % 2) * OUT_CHUNK;
      if (t == 0) hopper::tma_store_wait_read<1>();   // buf's last store
      hopper::named_sync(1 + cw, 128);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * c + jj;
        // an odd N's last column pair reads w_scale[N - 1] twice (column N
        // is clipped by the TMA store): a clamped index, not a second
        // predicate, which slowed the prefill epilogue (`PERF.md`)
        const int n = o.y + 8 * j + 2 * (lane % 4);
        const bool in = n < sh.N;
        const float s0 = in ? __fmul_rn(xs, w_scale[n]) : 0.f;
        const float s1 = in ? __fmul_rn(xs, w_scale[min(n + 1, sh.N - 1)])
                            : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r + 8 * h;
          const int piece = (2 * jj + (lane % 4) / 2) ^ (rr % 8);
          *reinterpret_cast<float2*>(buf + rr * 128 + piece * 16 +
                                     8 * (lane % 2)) =
              make_float2(
                  __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0),
                  __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1));
        }
      }
      hopper::fence_async_shared();
      hopper::named_sync(1 + cw, 128);
      if (t == 0) {
        hopper::tma_store_3d(map_o, buf, o.y + 32 * c, o.x + 64 * cw, 0);
        hopper::tma_store_commit();
      }
    }
  }
  if (t == 0) hopper::tma_store_wait_read<0>();
}

template <int BN>
__global__ void __launch_bounds__(P_THREADS, 1)
int8_matmul_prefill_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_o,
                           const float* __restrict__ x_scale,
                           const float* __restrict__ w_scale,
                           const Shape sh) {
  using P = Prefill<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - hopper::smem_u32(smem_raw) % 1024) % 1024);
  Bars* bars = reinterpret_cast<Bars*>(smem + P::OFF_BAR);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      hopper::mbar_init(&bars->full[s], 1);
      hopper::mbar_init(&bars->empty[s], P_CONSUMERS);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {          // producer
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;                   // stages filled so far
      for (int tile = first_tile(); tile < sh.tiles; tile += gridDim.x) {
        const int2 o = tile_origin<BN>(sh, tile);
        for (int kt = 0; kt < sh.nkt; ++kt, ++it) {
          const int s = it % P_STAGES;
          if (it >= P_STAGES)
            hopper::mbar_wait(&bars->empty[s], (it / P_STAGES - 1) & 1);
          hopper::mbar_arrive_expect_tx(&bars->full[s], P::STAGE);
          uint8_t* st = smem + s * P::STAGE;
          hopper::tma_load_3d(st, &map_x, &bars->full[s], kt * BK, o.x, 0);
          hopper::tma_load_3d(st + P::A_TILE, &map_w, &bars->full[s],
                              kt * BK, o.y, 0);
        }
      }
    }
  } else {                          // consumers
    hopper::regs_inc<232>();
    prefill_consume<BN>(smem, bars, &map_o, x_scale, w_scale, sh);
  }
}

// ---- decode ---------------------------------------------------------------

constexpr int D_BN = 64;               // output columns (weight rows) a block
constexpr int D_STAGES = 4, D_THREADS = 160;   // consumer warpgroup + warp
// K is split over a cluster of up to 8 blocks (the portable cluster size)
// while the blocks do not fill the SMs once and each split keeps at least
// SPLIT_MIN_KT k-tiles: a cluster's reduction costs more than it saves on
// a short K range
constexpr int MAX_SPLIT = 8, SPLIT_FILL = 1, SPLIT_MIN_KT = 16;

template <int MN>
struct Decode {
  static constexpr int W_TILE = D_BN * BK;           // 8 KB
  static constexpr int STAGE = W_TILE + MN * BK;     // + x's rows
  static constexpr int OFF_RED = D_STAGES * STAGE;   // partial sums
  static constexpr int OFF_BAR = OFF_RED + D_BN * MN * 4;
  static constexpr size_t SMEM = OFF_BAR + 2 * D_STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
};

struct DecodeShape {
  int M, N, ldo, nkt, per_split;       // k-tiles in all, and per split
};

template <int MN>
__device__ __forceinline__ void wgmma_mn(int (&d)[MN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (MN == 8)
    hopper::wgmma_m64n8k32_s8(d, a, b, 1);
  else if constexpr (MN == 16)
    hopper::wgmma_m64n16k32_s8(d, a, b, 1);
  else if constexpr (MN == 32)
    hopper::wgmma_m64n32k32_s8(d, a, b, 1);
  else
    hopper::wgmma_m64n64k32_s8(d, a, b, 1);
}

template <int MN>
__global__ void __launch_bounds__(D_THREADS)
int8_matmul_decode_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const float* __restrict__ x_scale,
                          const float* __restrict__ w_scale,
                          float* __restrict__ out, const DecodeShape sh) {
  using P = Decode<MN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - hopper::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::OFF_BAR);
  uint64_t* empty = full + D_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int n0 = blockIdx.x * D_BN;
  const int kt0 = blockIdx.y * sh.per_split;
  const int cnt = max(0, min(sh.nkt - kt0, sh.per_split));
  int acc[MN / 2];
#pragma unroll
  for (int i = 0; i < MN / 2; ++i) acc[i] = 0;

  if (threadIdx.x >= 128) {           // producer warp
    if (threadIdx.x == 128) {
      for (int i = 0; i < cnt; ++i) {
        const int s = i % D_STAGES, k = (kt0 + i) * BK;
        if (i >= D_STAGES)
          hopper::mbar_wait(&empty[s], (i / D_STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], P::STAGE);
        uint8_t* st = smem + s * P::STAGE;
        hopper::tma_load_3d(st, &map_w, &full[s], k, n0, 0);
        hopper::tma_load_3d(st + P::W_TILE, &map_x, &full[s], k, 0, 0);
      }
    }
    __syncwarp();
  } else {                            // consumer warpgroup
    for (int i = 0; i < cnt; ++i) {
      const int s = i % D_STAGES;
      const uint8_t* w = smem + s * P::STAGE;
      hopper::mbar_wait(&full[s], (i / D_STAGES) & 1);
      const uint64_t dw = hopper::desc_sw128(w, 16, 1024);
      const uint64_t dx = hopper::desc_sw128(w + P::W_TILE, 16, 1024);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_mn<MN>(acc, hopper::desc_advance(dw, kk * 32),
                     hopper::desc_advance(dx, kk * 32));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      hopper::mbar_arrive(&empty[s]);
    }
  }

  // split K: the cluster's int32 partial sums added into block 0's
  int* red = reinterpret_cast<int*>(smem + P::OFF_RED);
  const int t = threadIdx.x;
  if (gridDim.y > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (t < 128) {
#pragma unroll
      for (int i = 0; i < MN / 2; ++i) red[i * 128 + t] = acc[i];
    }
    cluster.sync();
    const unsigned rank = cluster.block_rank();
    if (rank == 0 && t < 128) {
      for (unsigned r = 1; r < gridDim.y; ++r) {
        const int* other = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int i = 0; i < MN / 2; ++i) acc[i] += other[i * 128 + t];
      }
    }
    cluster.sync();                   // the others' sums stay until read
    if (rank != 0) return;
  }
  if (t >= 128) return;

  // acc[4 j + e]: weight row (output column) n0 + r + 8 (e / 2), x row
  // (output row) 8 j + 2 (t % 4) + e % 2
  const int lane = t % 32;
  const int n_lo = n0 + 16 * (t / 32) + lane / 4;
  const float xs = *x_scale;
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sc[h] = n_lo + 8 * h < sh.N ? __fmul_rn(xs, w_scale[n_lo + 8 * h]) : 0.f;
#pragma unroll
  for (int j = 0; j < MN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * j + 2 * (lane % 4) + e % 2, n = n_lo + 8 * (e / 2);
      if (m < sh.M && n < sh.N)
        out[(size_t)m * sh.ldo + n] =
            __fmul_rn(__int2float_rn(acc[4 * j + e]), sc[e / 2]);
    }
  }
}

// ---- host -----------------------------------------------------------------

template <int BN>
cudaError_t launch_prefill(const void* x, const void* w, const float* xs,
                           const float* ws, float* out, int M, int N, int K,
                           int ldx, int ldw, int ldo, cudaStream_t st) {
  static bool configured = false;
  cudaError_t e = hopper::allow_smem(int8_matmul_prefill_kernel<BN>,
                                     Prefill<BN>::SMEM, configured);
  if (e) return e;
  CUtensorMap mx, mw, mo;
  constexpr CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if ((e = hopper::tiled_map(&mx, s8, x, K, M, 1, BK, P_BM, ldx)) ||
      (e = hopper::tiled_map(&mw, s8, w, K, N, 1, BK, BN, ldw)) ||
      (e = hopper::tiled_map(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, N, M,
                             1, 32, 64, ldo)))
    return e;
  const int tiles_m = (M + P_BM - 1) / P_BM;
  const Shape sh{M, N, (K + BK - 1) / BK, tiles_m,
                 tiles_m * ((N + BN - 1) / BN)};
  // persistent: one block an SM walks the tiles
  const int blocks = PERSISTENT ? std::min(sh.tiles, SM_COUNT) : sh.tiles;
  int8_matmul_prefill_kernel<BN>
      <<<blocks, P_THREADS, Prefill<BN>::SMEM, st>>>(mx, mw, mo, xs, ws, sh);
  return cudaGetLastError();
}

template <int MN>
cudaError_t launch_decode(const void* x, const void* w, const float* xs,
                          const float* ws, float* out, int M, int N, int K,
                          int ldx, int ldw, int ldo, cudaStream_t st) {
  static bool configured = false;
  cudaError_t e = hopper::allow_smem(int8_matmul_decode_kernel<MN>,
                                     Decode<MN>::SMEM, configured);
  if (e) return e;
  CUtensorMap mx, mw;
  constexpr CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if ((e = hopper::tiled_map(&mx, s8, x, K, M, 1, BK, MN, ldx)) ||
      (e = hopper::tiled_map(&mw, s8, w, K, N, 1, BK, D_BN, ldw)))
    return e;
  const int tiles = (N + D_BN - 1) / D_BN, nkt = (K + BK - 1) / BK;
  int split = 1;
  while (split < MAX_SPLIT && tiles * split < SPLIT_FILL * SM_COUNT &&
         nkt >= 2 * split * SPLIT_MIN_KT)
    split *= 2;
  const DecodeShape sh{M, N, ldo, nkt, (nkt + split - 1) / split};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, split, 1);
  cfg.blockDim = dim3(D_THREADS, 1, 1);
  cfg.dynamicSmemBytes = Decode<MN>::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, int8_matmul_decode_kernel<MN>, mx, mw, xs,
                         ws, out, sh);
  return e ? e : cudaGetLastError();
}

}  // namespace

// x (M, K), rows ldx bytes apart; w the (K, N) weight stored K-major, as
// the first K columns of a row-major (N, ldw) array; out (M, N) fp32, rows
// ldo floats apart; all 16-byte aligned, ldx and ldw multiples of 16 and ldo
// of 4 (TMA). The path is chosen by M alone: M <= 64 decode, else prefill.
extern "C" int int8_matmul_s8(const void* x, const void* w,
                              const void* x_scale, const void* w_scale,
                              void* out, int M, int N, int K, int ldx,
                              int ldw, int ldo, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < K || ldo < N ||
      ldx % 16 || ldw % 16 || ldo % 4)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  if (M <= 8) return launch_decode<8>(x, w, xs, ws, o, M, N, K, ldx, ldw,
                                      ldo, s);
  if (M <= 16) return launch_decode<16>(x, w, xs, ws, o, M, N, K, ldx, ldw,
                                        ldo, s);
  if (M <= 32) return launch_decode<32>(x, w, xs, ws, o, M, N, K, ldx, ldw,
                                        ldo, s);
  if (M <= 64) return launch_decode<64>(x, w, xs, ws, o, M, N, K, ldx, ldw,
                                        ldo, s);
  // 128 x 256 tiles where they fill the card, else 128 x 128
  const long tiles256 = (long)((M + P_BM - 1) / P_BM) * ((N + 255) / 256);
  return tiles256 >= SM_COUNT
             ? launch_prefill<256>(x, w, xs, ws, o, M, N, K, ldx, ldw,
                                   ldo, s)
             : launch_prefill<128>(x, w, xs, ws, o, M, N, K, ldx, ldw,
                                   ldo, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
