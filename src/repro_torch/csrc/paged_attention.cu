// Paged-attention decode for Hopper (sm_90a), bf16 in and out.
//
// Replaces: the Pallas TPU kernel `paged_attention_kernel` (`_pa_kernel`)
// in src/repro/kernels/paged_attention/kernel.py. One query token per
// sequence attends over its KV cache, which lives in a pool of fixed-size
// pages addressed through a per-sequence block table. Query head h reads
// KV head h / G. fp32 online softmax scaled by 1/sqrt(D); positions at or
// past seq_len (clipped to max_pages * page) are masked. A sequence with
// seq_len 0 (an idle decode slot) gets the mean of V over all
// max_pages * page positions its block-table row gathers, as the
// reference's served decode (`paged_attention_ref`) gives it: the kernel
// runs the same softmax with every score 0 over the whole row, and reads
// no K for it.
//
// What bounds it on this card: device-memory bytes. Every valid position's
// K and V row (2 * D * 2 bytes per KV head) is read once and used for G
// dot products and G multiply-adds per element, 4 * G * D FLOPs on
// 4 * D bytes: G (1 for codeqwen1.5-7b, 4 for llama31-8b, 7 for
// qwen2-vl-7b, 8 for qwen3-30b-a3b, 48 for granite-34b) FLOPs per byte, far under the ~295
// FLOP/byte where the tensor cores would bound.
// At the served shapes a call moves 10-25 MB, 3-7 microseconds at 3.35
// TB/s, so what decides its time is how many bytes each SM keeps in
// flight and how long each block's chain of dependent steps is.
//
// What the design does about it:
//  - Fill the card: the pages of one (sequence, KV head) are split over a
//    cluster of `split` blocks (a power of 2 up to 8, the portable cluster
//    size), each taking a fixed run of `per` 16-key tiles of the row.
//    Both come from the shapes alone, never from seq_lens, so a CUDA graph
//    replays the launch, and a block's page ids load at once beside
//    seq_len. At the served shape (B 8, Hkv 8) that is 512 blocks of 4
//    warps on 132 SMs; registers are capped at 96 so that 5 blocks fit an
//    SM, because at 4 only 62 clusters of 8 fit the card at once and
//    llama31-8b's 64 ran in two waves.
//  - Keep bytes in flight: every thread issues 16-byte cp.async copies of
//    K and V rows (256 bytes a key per KV head, rows Hkv * D * 2 bytes
//    apart in the pool, found through the block table) into a ring of NS
//    tiles, NS - 1 tiles ahead of use.
//  - One rescale per tile (a page at page 16), not per key, and one block
//    barrier per tile: every warp computes the tile's 16 x G scores itself
//    with 8 mma.sync m16n8k16 (the bf16 q and K, products summed in fp32;
//    no rounding that the plain version does not do), takes the tile's max,
//    exponentials and sum in registers with 3 shuffles each, and rescales
//    its accumulators once; thread t owns dimension t of all G heads and
//    adds the tile's 16 keys of V in fp32 FMAs: P is never rounded to bf16.
//    A block has one thread per dimension (D 128: 4 warps; D 64: 2), and
//    a thread copies one 16-byte chunk of two of a tile's keys.
//  - At most 8 query heads a block, the columns of one mma's B operand: a
//    group of G <= 8 pads the columns with zeros; a larger group (G 48,
//    granite-34b's multi-query heads) is cut into G / 8 sub-groups of 8 on
//    the grid's y (which then counts Hkv * G / 8 rows of blocks), each
//    block reading its KV head's K and V itself. A sequence's K and V for
//    the sub-groups after the first come from the 50 MB L2, and the
//    sub-groups fill the card where one KV head a sequence would not (8
//    sequences: 384 blocks, not 64).
//  - Combine without a second round trip: after its tiles a block sends,
//    through distributed shared memory, each other block the partial sums
//    of the D / split dimensions that block combines, and its running max
//    and sum to all; after one cluster barrier every block combines its
//    own dimensions exactly, as
//    `repro.parallel.collectives.combine_partial_softmax` does. A block
//    with no tiles still arrives at the barriers and sends m = -1e30,
//    l = 0, acc = 0, which the combine weights as 0.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TK = 16;            // keys a tile (one mma row block):
                                  // one rescale each
constexpr int NS = 4;             // tiles in the ring
constexpr int MAX_SPLIT = 8;      // blocks a cluster
constexpr int SM_COUNT = 132;
constexpr int BT_CAP = 256;       // page ids a block keeps (host-checked)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the cluster barrier in two halves: every thread of every block arrives,
// then waits; `release`/`acquire` order the distributed shared-memory
// stores before it against the loads after it
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::);
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::);
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::);
}

// A (16 keys x 16 of D, row-major in shared memory) for mma m16n8k16
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// c += a b: 16 keys x 8 heads, bf16 products summed in fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Shape {
  int Hkv, page, max_pages;
  int split, per;                 // blocks a row, tiles a block at most
  float scale;
};

// D: head_dim, one thread a dimension. GB: query heads a block (<= 8, the
// mma's columns); SUB: blocks a KV head's group is cut into, G = GB * SUB.
// 5 blocks an SM at D 128 (the registers this leaves a thread), 10 at D 64
template <int D, int GB, int SUB>
__global__ void __launch_bounds__(D, 640 / D)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens,
                       __nv_bfloat16* __restrict__ out, const Shape sh) {
  constexpr int THREADS = D, NWARP = THREADS / 32;
  constexpr int ROW = D + 8;      // a key's row in shared memory, padded
                                  // so ldmatrix's 8 rows hit 32 banks
  constexpr int CH = D / 8;       // 16-byte chunks of a key's row
  static_assert(GB >= 1 && GB <= 8 && D % 64 == 0 && THREADS / CH == 8 &&
                    TK == 16,
                "a tile is one mma row block of 16 keys and at most 8 heads; "
                "a thread copies one chunk of two of its keys");
  __shared__ __align__(16) __nv_bfloat16 ring[NS][2][TK][ROW];  // K, V
  __shared__ __align__(16) float s_p[NWARP][GB][TK];
  __shared__ float s_alpha[NWARP][GB];
  // what the cluster's blocks send this one: their partial sums for the
  // D / split dimensions it combines, and their m and l
  __shared__ float recv[GB * D];
  __shared__ float recv_m[MAX_SPLIT][GB], recv_l[MAX_SPLIT][GB];
  __shared__ int s_bt[BT_CAP];

  cluster_arrive_relaxed();       // matched before the first remote store
  const int rank = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / SUB;                  // the KV head
  const int hq0 = h * GB * SUB + (blockIdx.y % SUB) * GB;  // first q head
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int Hq = sh.Hkv * GB * SUB;

  // this block's tiles: [t0, t0 + per) of the row, from the shapes alone,
  // so its page ids load beside seq_len; a seq_len-0 row takes every
  // position its block-table row gathers
  const int full = sh.max_pages * sh.page;
  const int t0 = rank * sh.per;
  const int pg0 = t0 * TK / sh.page;
  const int n_pg =
      min((t0 + sh.per) * TK / sh.page + 1, sh.max_pages) - pg0;
  const int* bt = block_tables + (size_t)b * sh.max_pages;
  for (int i = t; i < n_pg; i += THREADS) s_bt[i] = bt[pg0 + i];
  const int sl = seq_lens[b];
  const bool idle = sl <= 0;
  const int len = idle ? full : min(sl, full);
  const int cnt = max(0, min(sh.per, (len + TK - 1) / TK - t0));

  // q as the mma's B operand (16 of D x 8 heads, "col" layout): lane l
  // holds head l / 4, dimensions 2 (l % 4) + {0, 1, 8, 9} of each 16
  const int gq = lane / 4, kq = 2 * (lane % 4);
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0;
    if (gq < GB && !idle) {
      const __nv_bfloat16* qr = q + ((size_t)b * Hq + hq0 + gq) * D;
      qb[kk][0] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + kq);
      qb[kk][1] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + kq + 8);
    }
  }
  __syncthreads();                // s_bt

  // thread t copies keys t / CH and t / CH + 8, 16-byte chunk t % CH, of
  // K (not for an idle row: its scores are all 0) and V
  const size_t row_stride = (size_t)sh.Hkv * D;
  const int c16 = t % CH;
  auto issue = [&](int i) {
    if (i < cnt) {
      const int st = i % NS;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = t / CH + 8 * u, pos = (t0 + i) * TK + j;
        const bool valid = pos < len;
        const int pp = valid ? pos : t0 * TK;
        const int pi = pp / sh.page;
        const size_t off =
            ((size_t)s_bt[pi - pg0] * sh.page + (pp - pi * sh.page)) *
                row_stride + (size_t)h * D + c16 * 8;
        if (!idle) cp_async16(&ring[st][0][j][c16 * 8], k_pool + off, valid);
        cp_async16(&ring[st][1][j][c16 * 8], v_pool + off, valid);
      }
    }
    cp_async_commit();            // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);

  // each warp scores the whole tile itself (the mma is cheap) and keeps
  // its own copy of the running m and l of the two heads its lane holds:
  // heads 2 (l % 4) and 2 (l % 4) + 1, keys l / 4 and l / 4 + 8
  const int g0 = kq;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.f;

  for (int i = 0; i < cnt; ++i) {
    const int st = i % NS;
    cp_async_wait<NS - 2>();
    __syncthreads();              // tile i landed; tile i - 1 is done
    issue(i + NS - 1);

    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if (!idle) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, &ring[st][0][lane % 16][kk * 16 + (lane / 16) * 8]);
        mma_bf16(c, a, qb[kk][0], qb[kk][1]);
      }
    }
    // the tile's softmax: c[e] is key l / 4 + 8 (e / 2), head g0 + e % 2
    const int key = (t0 + i) * TK + lane / 4;
    const bool valid[2] = {key < len, key + 8 < len};
    float p[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s0 = valid[0] ? c[e] * sh.scale : NEG_INF;
      const float s1 = valid[1] ? c[e + 2] * sh.scale : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[e], mx);
      p[e] = valid[0] ? __expf(s0 - m_new) : 0.f;
      p[e + 2] = valid[1] ? __expf(s1 - m_new) : 0.f;
      float sum = p[e] + p[e + 2];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[e] = __expf(m[e] - m_new);
      l[e] = l[e] * alpha[e] + sum;
      m[e] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (g0 + e < GB) {
        s_p[warp][g0 + e][lane / 4] = p[e];
        s_p[warp][g0 + e][lane / 4 + 8] = p[e + 2];
        if (lane < 4) s_alpha[warp][g0 + e] = alpha[e];
      }
    }
    __syncwarp();

    // P V in fp32: thread t owns dimension t of every head
#pragma unroll
    for (int g = 0; g < GB; ++g) acc[g] *= s_alpha[warp][g];
#pragma unroll
    for (int k = 0; k < TK; k += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __bfloat162float(ring[st][1][k + e][t]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float4 pk = *reinterpret_cast<const float4*>(&s_p[warp][g][k]);
        acc[g] = fmaf(pk.x, v[0], acc[g]);
        acc[g] = fmaf(pk.y, v[1], acc[g]);
        acc[g] = fmaf(pk.z, v[2], acc[g]);
        acc[g] = fmaf(pk.w, v[3], acc[g]);
      }
    }
    __syncwarp();                 // s_p is rewritten by the next tile
  }
  cp_async_wait<0>();

  // the split: block r combines dimensions [r, r + 1) * D / split of every
  // head; each block sends it those partial sums, and its m and l to all
  cg::cluster_group cluster = cg::this_cluster();
  const int dn = D / sh.split;
  cluster_wait();                 // every block of the cluster has started
  {
    float* dst = cluster.map_shared_rank(recv, t / dn);
#pragma unroll
    for (int g = 0; g < GB; ++g) dst[(rank * GB + g) * dn + t % dn] = acc[g];
  }
  if (warp == 0 && lane < 4) {
    for (int r = 0; r < sh.split; ++r) {
      float* rm = cluster.map_shared_rank(&recv_m[rank][0], r);
      float* rl = cluster.map_shared_rank(&recv_l[rank][0], r);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (g0 + e < GB) {
          rm[g0 + e] = m[e];
          rl[g0 + e] = l[e];
        }
      }
    }
  }
  cluster_arrive_release();
  cluster_wait();                 // every block's partials are here
  for (int idx = t; idx < GB * dn; idx += THREADS) {
    const int g = idx / dn, dd = idx % dn;
    float mx = NEG_INF;
    for (int r = 0; r < sh.split; ++r) mx = fmaxf(mx, recv_m[r][g]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < sh.split; ++r) {
      const float w = __expf(recv_m[r][g] - mx);
      den += recv_l[r][g] * w;
      num += recv[(r * GB + g) * dn + dd] * w;
    }
    out[((size_t)b * Hq + hq0 + g) * D + rank * dn + dd] =
        __float2bfloat16(den > 0.f ? num / den : 0.f);
  }
}

template <int D, int GB, int SUB>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* seq_lens, void* out,
                   int B, int Hkv, int page, int max_pages,
                   cudaStream_t stream) {
  // split the row's tiles over a power of 2 of blocks, up to 8, fewer
  // where the row has fewer tiles or the blocks would be more than 8 an
  // SM; from the shapes alone. A row is a (sequence, KV head, sub-group).
  const int tiles = (max_pages * page + TK - 1) / TK;
  const long rows = (long)B * Hkv * SUB;
  int split = 1;
  while (split * 2 <= std::min(MAX_SPLIT, tiles) &&
         rows * split * 2 <= 8L * SM_COUNT)
    split *= 2;
  const int per = (tiles + split - 1) / split;
  if (per * TK / page + 2 > BT_CAP) return cudaErrorInvalidValue;
  const Shape sh{Hkv, page, max_pages, split, per, 1.0f / sqrtf((float)D)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Hkv * SUB, B);
  cfg.blockDim = dim3(D, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<D, GB, SUB>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), sh);
  return e ? e : cudaGetLastError();
}

}  // namespace

// Instantiated for what the registered configs use, as (head_dim D,
// query heads per KV head G): (128, 4) llama31-8b, jamba-v0.1-52b,
// mixtral-8x7b and phi3-medium-14b; (128, 8) qwen3-30b-a3b; (128, 1)
// codeqwen1.5-7b; (128, 6) nemotron-4-15b; (128, 7) qwen2-vl-7b (its
// eighth mma column zero, as G 6's last two); (128, 5)
// llama4-maverick-400b-a17b (columns 6-8 zero); (128, 48) granite-34b, as
// 6 sub-groups of 8; (64, 2) granite-moe-1b-a400m. A config that needs
// another (D, G) adds its instantiation here and in the wrapper's list.
// q, the pools and out 16-byte aligned (the rows are read 16 bytes at a
// time).
extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool,
                                    const void* block_tables,
                                    const void* seq_lens, void* out, int B,
                                    int Hq, int Hkv, int D_, int page,
                                    int max_pages, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || page <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
#define PAGED_CASE(D, GB, SUB)                                             \
  if (D_ == D && G == GB * SUB)                                            \
    return launch<D, GB, SUB>(q, k_pool, v_pool, block_tables, seq_lens,   \
                              out, B, Hkv, page, max_pages, s);
  PAGED_CASE(128, 4, 1)
  PAGED_CASE(128, 8, 1)
  PAGED_CASE(128, 1, 1)
  PAGED_CASE(128, 6, 1)
  PAGED_CASE(128, 7, 1)
  PAGED_CASE(128, 5, 1)
  PAGED_CASE(128, 8, 6)
  PAGED_CASE(64, 2, 1)
#undef PAGED_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
