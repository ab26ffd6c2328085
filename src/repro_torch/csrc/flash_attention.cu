// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` (`_fa_kernel`)
// in src/repro/kernels/flash_attention/kernel.py. GQA attention (query
// head h reads KV head h / G), causal with the top-left mask `col <= row`
// or full, fp32 scores scaled by 1/sqrt(D), fp32 online softmax and fp32
// accumulator. Any Sq and Sk: the kernel masks the ragged edge itself, so
// the Pallas kernel's divisibility assert (prompts are padded to multiples
// of 64, not 128) does not apply. An optional kv_len (B,), clipped to Sk,
// masks keys at or past kv_len[b], as the reference model's prefill
// attention does for padded prompts; a sequence with kv_len 0 gets there
// the softmax of all-equal masked scores, the mean of V over all Sk keys,
// and here too, from one pass over V with no scores. D is 128 or 64.
//
// What bounds it on this card: it does 4*Sq*Sk*D/2 FLOPs per (sequence,
// head) when causal against 2*(2*Sq + 2*Sk/G)*D bytes (q and out per
// query head, K and V per KV head), so FLOPs per byte grow with the
// sequence. At the served prefill shape (Sq = Sk = 512, D = 128, G = 4)
// that is about 100 FLOP/byte, under the ~295 where the bf16 tensor cores
// would bound: device-memory bytes set the least time there, and
// operations do from about 1.5k tokens up. At D 64 (granite-moe-1b-a400m)
// the products halve and so do the bytes: the same balance.
//
// What the design does about it: the products run on the tensor cores
// (bf16 wgmma, fp32 accumulators) and the tiles arrive by TMA, so no
// thread spends instructions on addresses or loads. A block owns 128 query
// rows of one head of one sequence and has three warpgroups. Warpgroup 0
// is the producer: one thread loads the Q tile once, then K and V tiles of
// 64 keys into a ring of two stages in shared memory, each stage with a
// "full" mbarrier (the copies' bytes landed) and an "empty" one (both
// consumers are done with it); it gives up registers (setmaxnreg) to the
// consumers. Warpgroups 1 and 2 each own 64 query rows. Per key tile:
// S = Q K^T as D / 16 wgmma m64n64k16 with both operands in shared memory
// (K-major: D is contiguous in the (B, S, H, D) layout); masks only on
// tiles that cross the causal diagonal or the kv_len edge (TMA fills rows
// past Sk with zeros, which the kv_len mask covers); the online softmax in
// registers (each row's max over the four lanes of a quad, exp2 with the
// scale folded in, O rescaled only where the max moved, row sums kept per
// thread and summed once at the end); then O += P V as wgmma m64nDk16
// with P taken from the registers as the A operand (the accumulator layout
// of S is the A-fragment layout, so P never touches shared memory) and V
// from shared memory N-major. P goes in as three bf16 terms, each the
// rounded remainder of the ones before, which carry its 24 bits: one bf16
// P (what the reference model's jnp attention does) moves rows that
// attend to a few keys by up to 4 steps of the one-bf16-step gate against
// the plain version's fp32 P; two terms (p to 2^-18) pass the gate but
// flip bf16 roundings of the output often enough that a 2-layer int8
// llama31-8b's K/V end 0.057 from its CPU run (int8's per-tensor
// activation quantization turns one flipped bf16 step into one int8
// step); three leave it at 0, as the fp32 plain version does. Three terms
// of a 128-key tile held in registers with S and O made ptxas spill, so
// the K/V tiles are 64 keys. Tiles past min(kv_len, the diagonal) are
// never loaded. The epilogue divides by the row sums, rounds to bf16 into
// the (finished) Q tile and stores it with TMA, which clips rows past Sq.
// Blocks run the longest causal Q tiles first, and the G query heads of a
// KV head are neighbours so that their K and V tiles come from L2. Not
// done yet: overlapping one tile's softmax with the next tile's products
// (ping-pong between the consumers), a persistent grid that hides each
// block's prologue and epilogue, TMA multicast across a cluster.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;                // query rows per block, 64 a consumer
constexpr int BK = 64;                 // keys per K/V tile
constexpr int STAGES = 2;              // K/V tiles in flight
constexpr int THREADS = 384;           // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
// Tiles are stored as D / 64 column halves of 64 (128-byte rows, the
// swizzle's width), each half rows x 128 bytes: two at head_dim 128, one
// at 64
constexpr int Q_HALF = BQ * 128;       // 16 KB
constexpr int KV_HALF = BK * 128;      // 8 KB

// The shared-memory layout at head_dim D: the Q tile, the K and V rings,
// the barriers.
template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int HALVES = D / 64;
  static constexpr int Q_TILE = HALVES * Q_HALF;
  static constexpr int KV_TILE = HALVES * KV_HALF;
  static constexpr int OFF_K = Q_TILE;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE;
  static constexpr size_t SMEM = OFF_BAR + 64 + 1024;  // + barriers, align
};

struct Barriers {
  uint64_t q, full[STAGES], empty[STAGES];
};

struct Shape {
  int B, Sq, Sk, Hq, Hkv, causal, n_qt;
};

// A block's work: query head h of sequence b, query rows q0 to q0 + BQ -
// 1, KV head hk, kvl valid keys in n_kt key tiles (when causal, those up
// to the block's last row below Sq). The last Q tiles (the most key
// tiles) run first, and a KV head's G query heads side by side.
struct Place {
  int h, b, hk, q0, kvl, n_kt;
};

// Read anew by each role after its register reallocation, from a
// volatile read of %ctaid.x that the compiler can neither hoist nor merge:
// a value live across setmaxnreg is spilled to local memory by ptxas.
__device__ __forceinline__ Place locate(const Shape& sh, const int* kv_len) {
  int id;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(id));
  Place p;
  p.h = id % sh.Hq;
  p.b = (id / sh.Hq) % sh.B;
  p.hk = p.h / (sh.Hq / sh.Hkv);
  p.q0 = (sh.n_qt - 1 - id / (sh.Hq * sh.B)) * BQ;
  p.kvl = kv_len == nullptr ? sh.Sk : min(sh.Sk, kv_len[p.b]);
  p.n_kt = (p.kvl + BK - 1) / BK;
  if (sh.causal) p.n_kt = min(p.n_kt, (min(p.q0 + BQ, sh.Sq) - 1) / BK + 1);
  return p;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A sequence with no valid key: every row of the block is the mean of V
// over all Sk keys of KV head hk, summed in fp32 with 16-byte loads (at D
// 128, 24 rows side by side, 16 chunks of 8 values each) and written with
// 16-byte stores.
template <int D>
__device__ void mean_of_v(uint8_t* smem, const __nv_bfloat16* v,
                          __nv_bfloat16* out, int b, int h, int hk, int q0,
                          const Shape& sh) {
  constexpr int CH = D / 8, R = THREADS / CH;
  const int Sq = sh.Sq, Sk = sh.Sk, Hq = sh.Hq, Hkv = sh.Hkv;
  float* part = reinterpret_cast<float*>(smem);          // [R][D]
  __nv_bfloat16* mean = reinterpret_cast<__nv_bfloat16*>(part + R * D);
  const int c = threadIdx.x % CH, r0 = threadIdx.x / CH;
  float acc[8] = {};
#pragma unroll 8
  for (int row = r0; row < Sk; row += R) {      // 8 loads in flight
    const uint4 x = *reinterpret_cast<const uint4*>(
        v + (((size_t)b * Sk + row) * Hkv + hk) * D + c * 8);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(x2[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[r0 * D + c * 8 + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < D) {
    float s = 0.f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) s += part[r * D + threadIdx.x];
    mean[threadIdx.x] = __float2bfloat16(s / (float)Sk);
  }
  __syncthreads();
  const uint4* m4 = reinterpret_cast<const uint4*>(mean);
  const int rows = min(BQ, Sq - q0);
  for (int i = threadIdx.x; i < rows * CH; i += THREADS)
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * Sq + q0 + i / CH) * Hq + h) * D + (i % CH) * 8) =
        m4[i % CH];
}

// The two consumer warpgroups: 64 query rows each.
template <int D>
__device__ __forceinline__ void consume(uint8_t* smem, Barriers* bars,
                                        const CUtensorMap* map_o,
                                        const Place& p, int causal) {
  const int b = p.b, h = p.h, q0 = p.q0, kvl = p.kvl, n_kt = p.n_kt;
  const int cw = threadIdx.x / 128 - 1;       // 0 or 1
  const int t = threadIdx.x % 128, lane = t % 32;
  const int qd = lane % 4;
  const int row_lo = q0 + 64 * cw;            // this warpgroup's first row
  const int row0 = row_lo + 16 * (t / 32) + lane / 4, row1 = row0 + 8;
  // when causal, tiles past this warpgroup's diagonal are all masked: it
  // only releases them. Every tile it runs keeps key k0 for every row (k0 <
  // kvl, and k0 <= row_lo when causal), so each row's max is finite.
  const int n_run = causal ? min(n_kt, row_lo / BK + 1) : n_kt;
  // exp(x / sqrt(D)) = exp2(x * sl)
  const float sl = 1.4426950408889634f / sqrtf((float)D);
  uint8_t* qs = smem + cw * (Q_HALF / 2);     // this warpgroup's 64 rows
  using L = Layout<D>;

  float o[D / 2];                             // 64 x D, fp32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(&bars->q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    const uint8_t* ks = smem + L::OFF_K + s * L::KV_TILE;
    const uint8_t* vs = smem + L::OFF_V + s * L::KV_TILE;
    hopper::mbar_wait(&bars->full[s], (kt / STAGES) & 1);
    if (kt >= n_run) {
      hopper::mbar_arrive(&bars->empty[s]);
      continue;
    }

    // S = Q K^T (64 x 64): D / 16 k-steps of 16 over D, 4 in each 64-wide
    // half
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint64_t dq = hopper::desc_sw128(qs, 16, 1024);
    const uint64_t dk = hopper::desc_sw128(ks, 16, 1024);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss<0>(
          sc, hopper::desc_advance(dq, (kk / 4) * Q_HALF + (kk % 4) * 32),
          hopper::desc_advance(dk, (kk / 4) * KV_HALF + (kk % 4) * 32), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);

    // masks only where the tile crosses the kv_len edge or the diagonal
    const int k0 = kt * BK;
    if (k0 + BK > kvl || (causal && k0 + BK - 1 > row_lo)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * qd + (i % 2);
        const int row = (i & 2) ? row1 : row0;
        if (col >= kvl || (causal && col > row)) sc[i] = -INFINITY;
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (mx0 > m0) {                 // rescale O and the sum where it moved
      const float a = ex2((m0 - mx0) * sl);
      l0 *= a;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= a;
        o[i + 1] *= a;
      }
      m0 = mx0;
    }
    if (mx1 > m1) {
      const float a = ex2((m1 - mx1) * sl);
      l1 *= a;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i + 2] *= a;
        o[i + 3] *= a;
      }
      m1 = mx1;
    }

    // P = exp2(s sl - m sl) in fp32, then its three bf16 terms, each the
    // rounded remainder of the ones before (the subtractions are exact)
    const float ms0 = m0 * sl, ms1 = m1 * sl;
    uint32_t pt[3][16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float ms = (i & 2) ? ms1 : ms0;
      float p0 = ex2(fmaf(sc[i], sl, -ms));
      float p1 = ex2(fmaf(sc[i + 1], sl, -ms));
      if (i & 2) l1 += p0 + p1; else l0 += p0 + p1;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const __nv_bfloat162 tb = __floats2bfloat162_rn(p0, p1);
        const float2 tf = __bfloat1622float2(tb);
        pt[n][i / 2] = *reinterpret_cast<const uint32_t*>(&tb);
        p0 -= tf.x;
        p1 -= tf.y;
      }
    }

    // O += P V: 4 k-steps of 16 keys, each running the three terms against
    // one descriptor of V, which is N-major (D contiguous): its 64-wide
    // halves KV_HALF bytes apart, 8-key groups 1024 bytes apart; N = D
    hopper::fence_operands(o);
    const uint64_t dv = hopper::desc_sw128(vs, KV_HALF, 1024);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t d = hopper::desc_advance(dv, kk * 2048);
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs<1>(o, pt[n][4 * kk], pt[n][4 * kk + 1],
                                         pt[n][4 * kk + 2], pt[n][4 * kk + 3],
                                         d, 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(o, pt[n][4 * kk], pt[n][4 * kk + 1],
                                        pt[n][4 * kk + 2], pt[n][4 * kk + 3],
                                        d, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
#pragma unroll
    for (int n = 0; n < 3; ++n) hopper::fence_operands(pt[n]);
    hopper::mbar_arrive(&bars->empty[s]);
  }

  // O / l in bf16 into this warpgroup's (finished) rows of the Q tile, in
  // the same swizzled layout, then one TMA store per 64-wide half
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int r = 16 * (t / 32) + lane / 4;     // row0 - row_lo; r % 8 = lane/4
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = i / 4, rr = r + 8 * ((i / 2) % 2);
    const float inv = (i & 2) ? inv1 : inv0;
    uint8_t* dst = qs + (j / 8) * Q_HALF + rr * 128 +
                   (((j % 8) ^ (rr % 8)) * 16) + 4 * qd;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[i] * inv, o[i + 1] * inv);
  }
  hopper::fence_async_shared();
  hopper::named_sync(1 + cw, 128);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < L::HALVES; ++half)
      hopper::tma_store_3d(map_o, qs + half * Q_HALF, h * D + 64 * half,
                           row_lo, b);
    hopper::tma_store_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ kv_len,
                       __nv_bfloat16* __restrict__ out, const Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - hopper::smem_u32(smem_raw) % 1024) % 1024);
  using L = Layout<D>;
  Barriers* bars = reinterpret_cast<Barriers*>(smem + L::OFF_BAR);

  {
    const Place p = locate(sh, kv_len);
    if (p.kvl <= 0) {
      mean_of_v<D>(smem, v, out, p.b, p.h, p.hk, p.q0, sh);
      return;
    }
  }
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars->q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bars->full[s], 1);
      hopper::mbar_init(&bars->empty[s], CONSUMERS);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {          // producer
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      const Place p = locate(sh, kv_len);
      const int b = p.b, kc = p.hk * D;
      hopper::mbar_arrive_expect_tx(&bars->q, L::Q_TILE);
#pragma unroll
      for (int half = 0; half < L::HALVES; ++half)
        hopper::tma_load_3d(smem + half * Q_HALF, &map_q, &bars->q,
                            p.h * D + 64 * half, p.q0, b);
      for (int kt = 0; kt < p.n_kt; ++kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        if (kt >= STAGES)
          hopper::mbar_wait(&bars->empty[s], (kt / STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(&bars->full[s], 2 * L::KV_TILE);
        uint8_t* ks = smem + L::OFF_K + s * L::KV_TILE;
        uint8_t* vs = smem + L::OFF_V + s * L::KV_TILE;
#pragma unroll
        for (int half = 0; half < L::HALVES; ++half)
          hopper::tma_load_3d(ks + half * KV_HALF, &map_k, &bars->full[s],
                              kc + 64 * half, k0, b);
#pragma unroll
        for (int half = 0; half < L::HALVES; ++half)
          hopper::tma_load_3d(vs + half * KV_HALF, &map_v, &bars->full[s],
                              kc + 64 * half, k0, b);
      }
    }
  } else {                          // consumers
    hopper::regs_inc<232>();
    consume<D>(smem, bars, &map_o, locate(sh, kv_len), sh.causal);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* o, int B, int Sq, int Sk, int Hq,
                   int Hkv, int causal, cudaStream_t st) {
  constexpr size_t SMEM = Layout<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e;
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((e = hopper::tiled_map(&mq, bf16, q, (uint64_t)Hq * D, Sq, B, 64,
                             BQ)) ||
      (e = hopper::tiled_map(&mk, bf16, k, (uint64_t)Hkv * D, Sk, B, 64,
                             BK)) ||
      (e = hopper::tiled_map(&mv, bf16, v, (uint64_t)Hkv * D, Sk, B, 64,
                             BK)) ||
      (e = hopper::tiled_map(&mo, bf16, o, (uint64_t)Hq * D, Sq, B, 64,
                             BQ / 2)))
    return e;
  const Shape sh{B, Sq, Sk, Hq, Hkv, causal, (Sq + BQ - 1) / BQ};
  flash_attention_kernel<D><<<sh.n_qt * Hq * B, THREADS, SMEM, st>>>(
      mq, mk, mv, mo, static_cast<const __nv_bfloat16*>(v), kv_len,
      static_cast<__nv_bfloat16*>(o), sh);
  return cudaGetLastError();
}

}  // namespace

// head_dim 128 (every registered config but one) or 64
// (granite-moe-1b-a400m). kv_len may be null: every key is then valid. q,
// k, v and out must be 16-byte aligned (TMA).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* out, int B, int Sq, int Sk, int Hq,
                                    int Hkv, int D_, int causal,
                                    void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Sk <= 0 || (D_ != 128 && D_ != 64))
    return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const int* kl = static_cast<const int*>(kv_len);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D_ == 128
             ? launch<128>(q, k, v, kl, out, B, Sq, Sk, Hq, Hkv, causal, s)
             : launch<64>(q, k, v, kl, out, B, Sq, Sk, Hq, Hkv, causal, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
