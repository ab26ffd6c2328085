// Fused block-wise 8-bit AdamW update of one parameter leaf, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel. It is the counterpart of the XLA fusion that
// the reference's jitted `adamw8bit` update compiles to
// (src/repro/training/optimizer.py, `upd` in `adamw8bit`): dequantize both
// int8 moments, update them, compute the new parameter, and re-encode the
// moments with new per-block absmax scales, with no fp32 copy of anything
// in device memory. Eager PyTorch would hold about eight fp32 temporaries
// of the leaf at once (17 GB at llama31-8b's embedding), which is what
// decides whether a full-width model trains on one card.
//
// For one leaf p (bf16, the dtype of the port's parameters on the card;
// last axis `last`, `rows` rows), its gradient g (bf16, or fp32 when
// accumulated), the int8 codes q_m, q_v (p's shape) and fp32
// block scales s_m, s_v ((rows, nb), nb = ceil(last / 256); a row's last
// block may be ragged), the bias corrections bc1, bc2 and the optional clip
// scale c (0-dim fp32 tensors on the card), every element computes, as the
// compiled reference does (`kernels/adamw8bit/ref.py` is the same function
// in torch ops):
//     g  = round_to_g(g * round_to_g(c))       (only with a clip scale)
//     m  = fma(g, 1 - b1, dq(q_m, s_m) * b1)   dq(q, s) = sign(y) y^2 s,
//     v  = fma(g * (1 - b2), g, dq(q_v, s_v) * b2)       y = q * fl32(1/127)
//     u  = (m / bc1) * (1 / sqrt(v / bc2 + eps^2))
//     u  = fma(p, wd, u)                       (only where wd != 0)
//     p  = bf16(fma(-u, lr, p))
// then each 256-wide block's scale max(max |m|, 1e-12) (pad lanes of a
// ragged tail count as 0) and its codes round(sign(m) sqrt(|m| / scale)
// 127), clipped to +-127; likewise v. A bf16 clip product is exact in fp32,
// so rounding it to bf16 is the reference's bf16 multiply.
//
// Rounding: the build allows contraction (no -fmad=false), so every
// product, sum, quotient and square root is written as a `_rn` intrinsic
// and every fused multiply-add as `__fmaf_rn`, where the compiled reference
// fuses one; `rintf` rounds half to even as `jnp.round` does. The PTX then
// holds mul.rn/add.rn/sub.rn/div.rn/sqrt.rn/fma.rn.f32 and nothing ptxas
// may contract (`chip_smoke.py` phase 2 checks it).
//
// What bounds it on this card: bytes. An element reads g and p (2 + 2
// bytes in bf16) and its two codes, and writes p and the codes back: 10
// bytes, plus 16 bytes of scales a block, 1.58 ms at the embedding
// (128256 x 4096) at 3.35 TB/s. Its fp32 work, five correctly rounded
// quotients and three square roots an element (each a short Newton
// sequence), is about a tenth of the card's fp32 issue rate at that
// bandwidth.
//
// Design: one block of 64 threads per (row, 256-wide block): a thread owns
// the elements t, t + 64, t + 128, t + 192 of it (a warp's loads of one
// step are 32 consecutive elements), keeps its new m and v in registers,
// and the block finds both absmaxes with warp shuffles and one exchange
// through shared memory. The grid is rows x nb blocks (2,052,096 at the
// embedding), one launch a leaf. `skip_last_block` plants the checks'
// fault: the last block of every row keeps its old codes and scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;          // elements a quantization block
constexpr int kThreads = 64;
constexpr int kPer = kBlock / kThreads;

struct Consts {
  float lr, b1, c1, b2, c2, eps2, wd, inv127;
};

__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float load(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(const float*, float x) { return x; }

// max that keeps a NaN, as jnp.max and jnp.maximum do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// sign(y) * y^2 * scale, y = q * fl32(1/127)
__device__ __forceinline__ float dequant(int8_t q, float scale, float inv127) {
  const float y = __fmul_rn(static_cast<float>(q), inv127);
  return __fmul_rn(copysignf(__fmul_rn(y, y), y), scale);
}

// clip(round(sign(x) * sqrt(|x| / scale) * 127), -127, 127)
__device__ __forceinline__ int8_t quant(float x, float scale) {
  const float r = __fsqrt_rn(__fdiv_rn(fabsf(x), scale));
  const float y = rintf(__fmul_rn(copysignf(r, x), 127.0f));
  return static_cast<int8_t>(fminf(fmaxf(y, -127.0f), 127.0f));
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();                     // red is reused: m, then v
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return nanmax(red[0], red[1]);
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw8bit_kernel(const G* __restrict__ g, __nv_bfloat16* __restrict__ p,
                 int8_t* __restrict__ mq, float* __restrict__ ms,
                 int8_t* __restrict__ vq, float* __restrict__ vs,
                 const float* __restrict__ bc1p,
                 const float* __restrict__ bc2p,
                 const float* __restrict__ clip, Consts k, long long last,
                 int nb, int skip_last_block) {
  __shared__ float red[kThreads / 32];
  const long long bid = blockIdx.x;    // row * nb + block: the scales' index
  const long long row = bid / nb;
  const int blk = static_cast<int>(bid - row * nb);
  const long long base = row * last;
  const float bc1 = *bc1p, bc2 = *bc2p;
  const float sm_old = ms[bid], sv_old = vs[bid];
  const bool clipped = clip != nullptr;
  const float c = clipped ? round_to(g, *clip) : 1.0f;

  float m[kPer], v[kPer];
  float am = 0.0f, av = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long col = blk * kBlock + j * kThreads + threadIdx.x;
    m[j] = 0.0f;
    v[j] = 0.0f;
    if (col < last) {
      const long long i = base + col;
      float gi = load(g, i);
      if (clipped) gi = round_to(g, __fmul_rn(gi, c));
      const float mi = __fmaf_rn(gi, k.c1,
                                 __fmul_rn(dequant(mq[i], sm_old, k.inv127),
                                           k.b1));
      const float vi = __fmaf_rn(__fmul_rn(gi, k.c2), gi,
                                 __fmul_rn(dequant(vq[i], sv_old, k.inv127),
                                           k.b2));
      const float den = __fsqrt_rn(__fadd_rn(__fdiv_rn(vi, bc2), k.eps2));
      float u = __fmul_rn(__fdiv_rn(mi, bc1), __fdiv_rn(1.0f, den));
      const float pi = load(p, i);
      if (k.wd != 0.0f) u = __fmaf_rn(pi, k.wd, u);
      p[i] = __float2bfloat16_rn(__fmaf_rn(-u, k.lr, pi));
      m[j] = mi;
      v[j] = vi;
      am = nanmax(am, fabsf(mi));
      av = nanmax(av, fabsf(vi));
    }
  }
  const float sm = nanmax(block_max(am, red), 1e-12f);
  const float sv = nanmax(block_max(av, red), 1e-12f);
  if (skip_last_block && blk == nb - 1) return;     // the planted fault
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long col = blk * kBlock + j * kThreads + threadIdx.x;
    if (col < last) {
      mq[base + col] = quant(m[j], sm);
      vq[base + col] = quant(v[j], sv);
    }
  }
  if (threadIdx.x == 0) {
    ms[bid] = sm;
    vs[bid] = sv;
  }
}

template <typename G>
int launch(const void* g, void* p, void* mq, void* ms, void* vq, void* vs,
           const void* bc1, const void* bc2, const void* clip, Consts k,
           long long rows, long long last, int skip_last_block,
           cudaStream_t stream) {
  const int nb = static_cast<int>((last + kBlock - 1) / kBlock);
  const long long blocks = rows * nb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  adamw8bit_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(
      static_cast<const G*>(g), static_cast<__nv_bfloat16*>(p),
      static_cast<int8_t*>(mq), static_cast<float*>(ms),
      static_cast<int8_t*>(vq), static_cast<float*>(vs),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(clip), k, last, nb, skip_last_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g_bf16: 1 for a bf16 g, 0 for fp32; p is bf16. `clip` may be null (no
// clip scale). rows * ceil(last / 256) blocks, one launch.
extern "C" int adamw8bit_update(int g_bf16, const void* g,
                                void* p, void* mq, void* ms, void* vq,
                                void* vs, const void* bc1, const void* bc2,
                                const void* clip, float lr, float b1,
                                float c1, float b2, float c2, float eps2,
                                float wd, float inv127, long long rows,
                                long long last, int skip_last_block,
                                void* stream) {
  const Consts k{lr, b1, c1, b2, c2, eps2, wd, inv127};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || last <= 0) return 0;
  if (g_bf16)
    return launch<__nv_bfloat16>(g, p, mq, ms, vq, vs, bc1, bc2, clip, k,
                                 rows, last, skip_last_block, s);
  return launch<float>(g, p, mq, ms, vq, vs, bc1, bc2, clip, k, rows, last,
                       skip_last_block, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
