// Paged-attention decode for Hopper (sm_90a), bf16 in and out.
//
// Replaces: the Pallas TPU kernel `paged_attention_kernel` (`_pa_kernel`)
// in src/repro/kernels/paged_attention/kernel.py. One query token per
// sequence attends over its KV cache, which lives in a pool of fixed-size
// pages addressed through a per-sequence block table. Query head h reads
// KV head h / G. fp32 online softmax scaled by 1/sqrt(D); positions at or
// past seq_len are masked, and a sequence with seq_len 0 gets 0.
//
// What bounds it on this card: device-memory bytes. Every valid position's
// K and V row (2 * D * 2 bytes per KV head) is read once and used for G
// dot products and G multiply-adds per element, 4 * G * D FLOPs on
// 4 * D bytes: G (= 4 for llama31-8b, 8 for qwen3-30b-a3b) FLOPs per
// byte, far under the ~295 FLOP/byte where the tensor cores would bound.
//
// What the design does about it: one block per (sequence, KV head) packs
// the G query heads that share that KV head, so each K/V row is read from
// device memory once, not G times. The block reads only the pages below
// ceil(seq_len / page) through its own block-table row (what the TPU did
// with scalar prefetch). Each warp takes every NW-th token; a lane holds
// D/32 contiguous elements of q (fp32, pre-scaled), K and V, so a row is
// one coalesced warp-wide read and a dot product is a warp shuffle
// reduction. Each warp keeps its own running max, denominator and fp32
// accumulator per query head; the warps' partial softmaxes are combined
// exactly through shared memory at the end. Not done yet: with B*Hkv = 64
// blocks at the served shape, 132 SMs are under-filled; splitting the
// pages of one sequence over several blocks (split-K) is the remedy.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;             // warps per block
constexpr float NEG_INF = -1e30f;

template <int E>
__device__ inline void load_row(const __nv_bfloat16* p, float (&out)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 2) {
    float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + i));
    out[i] = f.x;
    out[i + 1] = f.y;
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int G>
__global__ void __launch_bounds__(NW * 32)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens,
                       __nv_bfloat16* __restrict__ out,
                       int Hkv, int page, int max_pages, float scale) {
  constexpr int E = D / 32;       // elements per lane
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Hq = Hkv * G;

  float qv[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<E>(q + ((size_t)b * Hq + h * G + g) * D + lane * E, qv[g]);
#pragma unroll
    for (int i = 0; i < E; ++i) qv[g][i] *= scale;
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  const int len = min(seq_lens[b], max_pages * page);
  const int* bt = block_tables + (size_t)b * max_pages;
  for (int t = warp; t < len; t += NW) {
    const size_t row =
        ((size_t)bt[t / page] * page + t % page) * Hkv + h;
    float kv[E], vv[E];
    load_row<E>(k_pool + row * D + lane * E, kv);
    load_row<E>(v_pool + row * D + lane * E, vv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) s += qv[g][i] * kv[i];
      s = warp_sum(s);
      const float m_new = fmaxf(m[g], s);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] = acc[g][i] * alpha + p * vv[i];
      m[g] = m_new;
    }
  }

  // combine the NW warps' partial softmaxes exactly
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) sm_acc[warp][g][lane * E + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = __expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    out[((size_t)b * Hq + h * G + g) * D + d] =
        __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* seq_lens, void* out,
                   int B, int Hkv, int page, int max_pages,
                   cudaStream_t stream) {
  paged_attention_kernel<D, G><<<dim3(B, Hkv), NW * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), Hkv, page, max_pages,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Instantiated for what the registered configs use: head_dim 128 with 4
// query heads per KV head (llama31-8b) or 8 (qwen3-30b-a3b). A config that
// needs another (D, G) adds its instantiation here and in the wrapper's
// list.
extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool,
                                    const void* block_tables,
                                    const void* seq_lens, void* out, int B,
                                    int Hq, int Hkv, int D, int page,
                                    int max_pages, void* stream) {
  if (Hkv <= 0 || D != 128) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hq == 4 * Hkv)
    return launch<128, 4>(q, k_pool, v_pool, block_tables, seq_lens, out, B,
                          Hkv, page, max_pages, s);
  if (Hq == 8 * Hkv)
    return launch<128, 8>(q, k_pool, v_pool, block_tables, seq_lens, out, B,
                          Hkv, page, max_pages, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
