// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` (`_fa_kernel`)
// in src/repro/kernels/flash_attention/kernel.py. GQA attention (query
// head h reads KV head h / G), causal with the top-left mask `col <= row`
// or full, fp32 scores scaled by 1/sqrt(D), fp32 online softmax and fp32
// accumulator. Any Sq and Sk: the kernel masks the ragged edge itself, so
// the Pallas kernel's divisibility assert (prompts are padded to multiples
// of 64, not 128) does not apply.
//
// What bounds it on this card: it does 4*Sq*Sk*D/2 FLOPs per (sequence,
// head) against 2*(2*Sq + 2*Sk/G)*D bytes (q and out per query head, K
// and V per KV head), so FLOPs per byte grow with the sequence. At the
// served prefill shape (Sq = Sk = 512, D = 128, G = 4) that is about 100
// FLOP/byte, under the ~295 where the bf16 tensor cores would bound:
// device-memory bytes set the least time there, and operations do from
// about 1.5k tokens up. This version, on fp32 FMAs (67 TFLOP/s peak), is
// held by its own arithmetic long before either.
//
// What the design does about it: a 64-row Q tile stays in shared memory
// (fp32, pre-scaled) while 64 x D tiles of K and V stream through it, so
// Q is read once and each K/V tile once per Q tile; the 64 x 64 score tile
// and the 64 x D accumulator never leave the SM. Tiles entirely above the
// causal diagonal are skipped, which halves the work. Each of 256 threads
// computes a 4 x 4 block of scores and a 4 x D/16 block of the output with
// plain fp32 FMAs, with rows and columns strided by 16 so that the
// shared-memory reads are conflict-free or broadcast. This first version
// leaves the tensor cores idle: mma.sync or wgmma on bf16 tiles, fed by
// TMA, is the next step and the reason it stays far from its bound.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key/value rows per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

__device__ inline float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads rows [row0, row0 + 64) of a (B, S, H, D) tensor at (b, h) into a
// padded fp32 tile, multiplied by `mul`; rows at or past S are zero.
template <int D, int LD>
__device__ inline void load_tile(float* tile, const __nv_bfloat16* x, int b,
                                 int h, int row0, int S, int H, float mul) {
  for (int idx = threadIdx.x; idx < 64 * D / 2; idx += THREADS) {
    const int r = idx / (D / 2), d = (idx % (D / 2)) * 2;
    const int row = row0 + r;
    float2 f = make_float2(0.f, 0.f);
    if (row < S) {
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          x + (((size_t)b * S + row) * H + h) * D + d));
    }
    tile[r * LD + d] = f.x * mul;
    tile[r * LD + d + 1] = f.y * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                       int Hq, int Hkv, int causal, float scale) {
  constexpr int DT = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                           // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);              // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);              // [BK][D]
  float* Ps = Vs + BK * D;                    // [BQ][BK + 1]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qb * BQ;

  load_tile<D, D + 1>(Qs, q, b, h, q0, Sq, Hq, scale);

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, min(q0 + BQ - 1, Sq - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // previous tile's Ks/Vs/Ps are consumed
    load_tile<D, D + 1>(Ks, k, b, hk, k0, Sk, Hkv, 1.f);
    load_tile<D, D>(Vs, v, b, hk, k0, Sk, Hkv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < Sk && (!causal || col <= row);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      o[tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, cudaStream_t st) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<D><<<grid, THREADS, bytes, st>>>(
      q, k, v, o, Sq, Sk, Hq, Hkv, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Instantiated for the head_dim of the registered configs (llama31-8b:
// 128). A config that needs another adds its instantiation here and in the
// wrapper's list.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int Hq, int Hkv, int D,
                                    int causal, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Sk <= 0 || D != 128)
    return cudaErrorInvalidValue;
  return launch<128>(static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v),
                     static_cast<__nv_bfloat16*>(out), B, Sq, Sk, Hq, Hkv,
                     causal, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
