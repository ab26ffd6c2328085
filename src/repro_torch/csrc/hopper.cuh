// Hopper (sm_90a) building blocks shared by the hand-written kernels: TMA
// tensor maps and copies, the dynamic shared memory a kernel may take,
// mbarriers, wgmma shared-memory descriptors and bf16 and int8 products,
// ldmatrix, named barriers and register reallocation between warpgroups.
// Nothing here knows what a kernel computes.
//
// The tensor maps need the driver's cuTensorMapEncodeTiled. The libraries
// link only the runtime, so it is fetched through the runtime's driver
// entry point: cuda.h is included for its types and enums alone.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

// ---- host: tensor maps ---------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, or null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a row-major (outer, rows, inner) array of bf16
// (CU_TENSOR_MAP_DATA_TYPE_BFLOAT16), fp32 (..._FLOAT32) or int8
// (..._UINT8: TMA moves bytes, their sign is the reader's) at `base`
// (16-byte aligned), read and written in boxes of box_rows x box_inner
// elements (one outer index) under the 128-byte swizzle that wgmma's B128
// layout reads (a box row at most 128 bytes: 64 bf16, 32 fp32 or 128
// int8). Rows lie `ld` elements apart (`inner` when ld is 0; ld * elem a
// multiple of 16 bytes), so the array may be the first `inner` columns of
// a wider one. Rows and elements past the array's edge (past `inner`, not
// `ld`) read as zeros and are never written. Built on the host for every
// launch and passed by value (a __grid_constant__ parameter), so a CUDA
// graph replays it with the addresses it was captured with.
inline cudaError_t tiled_map(CUtensorMap* map, CUtensorMapDataType type,
                             const void* base, uint64_t inner, uint64_t rows,
                             uint64_t outer, uint32_t box_inner,
                             uint32_t box_rows, uint64_t ld = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const uint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32    ? 4
                        : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2
                                                                   : 1;
  if (ld == 0) ld = inner;
  const cuuint64_t dims[3] = {inner, rows, outer};
  const cuuint64_t strides[2] = {ld * elem, ld * rows * elem};
  const cuuint32_t box[3] = {box_inner, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- host: launch attributes ---------------------------------------------

// Lets `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// launch gets unasked), once: `configured` is the caller's flag for this
// kernel, set when the attribute has been set.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = e == cudaSuccess;
  return e;
}

// ---- device: shared memory, mbarriers, TMA --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Called by one thread; then fence_mbar_init() and a block-wide barrier
// before any other thread uses the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of copies that will complete on
// the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity `parity` (the
// n-th completion, counting from 0, has parity n & 1). Bounded: after
// 2**34 clocks (about 9 s at 1.98 GHz) it traps, so a kernel whose phases
// are wrong fails its launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// Box (c0, c1, c2) of `map` (coordinates in elements, innermost first)
// into shared memory at `dst` (1024-byte aligned under the 128-byte
// swizzle); completes its bytes on `bar`. Issued by one thread.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (TMA stores, wgmma): each writing thread, before the barrier that
// hands the data over.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared memory at `src` to box (c0, c1, c2) of `map`; rows past the
// map's edge are not written. Issued by one thread, then tma_store_wait().
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// Commits the stores issued since the last commit as one group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N committed groups have yet to read their shared
// memory (which may then be reused, or the block exit).
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// Commits the issued stores and waits until they have read their shared
// memory.
__device__ __forceinline__ void tma_store_wait() {
  tma_store_commit();
  tma_store_wait_read<0>();
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// ---- device: registers between warpgroups ---------------------------------

// Every warp of the warpgroup executes it, in a branch that the other
// warpgroups' branches never rejoin (otherwise ptxas ignores it).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

// ---- device: wgmma -------------------------------------------------------

// The descriptor of a matrix operand in shared memory in the 128-byte
// swizzled layout that TMA writes under CU_TENSOR_MAP_SWIZZLE_128B: rows of
// 128 bytes, 8-row atoms of 1024 bytes, the tile 1024-byte aligned. Offsets
// in bytes. K-major operand (K contiguous): `sbo` is the stride between
// 8-row groups (1024 for packed rows), `lbo` is not read; a k-step of 16
// bf16 inside a 128-byte row is 32 bytes further. MN-major operand (M or N
// contiguous): `lbo` is the stride between 64-element blocks of M or N,
// `sbo` between 8-row groups of K. Moved along K with desc_advance.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The descriptor `bytes` further on (a multiple of 16, within the 256 KB
// of shared memory, so the start-address field does not overflow).
__device__ __forceinline__ uint64_t desc_advance(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// Before a warpgroup's first wgmma, and whenever its accumulator or A
// registers were written by other instructions since the last one.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads and writes of an accumulator
// register across the asynchronous wgmma that owns it: fenced after the
// wait, before its next use.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

// The same for an A operand in registers, which the wgmma reads until it
// has completed: fenced after the wait, it stays live until then.
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x) :: "memory");
}

__device__ __forceinline__ void fence_operand(int& x) {
  asm volatile("" : "+r"(x) :: "memory");
}

template <int N, typename T>
__device__ __forceinline__ void fence_operands(T (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(x[i]);
}

// wgmma's D: the asm string of its registers %0 .. %(n - 1), and the
// operands d[i] .. d[i + n - 1], fp32 (HOPPER_F) or int32 (HOPPER_R).
#define HOPPER_D4 "{%0, %1, %2, %3}"
#define HOPPER_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOPPER_D16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define HOPPER_D128                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"
#define HOPPER_F4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F8(d, i) HOPPER_F4(d, i), HOPPER_F4(d, i + 4)
#define HOPPER_F16(d, i) HOPPER_F8(d, i), HOPPER_F8(d, i + 8)
#define HOPPER_F32(d, i) HOPPER_F16(d, i), HOPPER_F16(d, i + 16)
#define HOPPER_F64(d, i) HOPPER_F32(d, i), HOPPER_F32(d, i + 32)
#define HOPPER_F128(d, i) HOPPER_F64(d, i), HOPPER_F64(d, i + 64)
#define HOPPER_R4(d, i) \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define HOPPER_R8(d, i) HOPPER_R4(d, i), HOPPER_R4(d, i + 4)
#define HOPPER_R16(d, i) HOPPER_R8(d, i), HOPPER_R8(d, i + 8)
#define HOPPER_R32(d, i) HOPPER_R16(d, i), HOPPER_R16(d, i + 16)
#define HOPPER_R64(d, i) HOPPER_R32(d, i), HOPPER_R32(d, i + 32)
#define HOPPER_R128(d, i) HOPPER_R64(d, i), HOPPER_R64(d, i + 64)

// The accumulator layout of wgmma m64nNk16 with fp32 D: thread t of the
// warpgroup holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, and
// d[4 j + e] is row r + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.

// D (64 x 64, fp32) = A (64 x 16) * B (16 x 64) + (accumulate ? D : 0),
// issued by one warpgroup; A and B bf16 in shared memory (descriptors), A
// K-major, B K-major (TRANS_B 0) or N-major (TRANS_B 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}"
      : HOPPER_F32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x N, fp32) = A (64 x 16) * B (16 x N) + (accumulate ? D : 0),
// A bf16 in registers, B bf16 in shared memory, K-major (TRANS_B 0) or
// N-major (1). A is four 32-bit registers a thread, each two bf16 (the
// lower column in the low half), in the accumulator's layout for a 64 x 16
// slice: a0 = (r, 2 (t % 4)), a1 = (r + 8, 2 (t % 4)), a2 = (r, 8 + 2 (t %
// 4)), a3 = (r + 8, 8 + 2 (t % 4)), so an accumulator converts to an A
// operand in place. They must not change until the product has completed
// (wgmma_wait).
// Named wgmma_m64n<N>k16_rs for N = 8, 16, 32, 64, 128, 256.
#define HOPPER_WGMMA_RS(N, R, DSTR, OPS, IA, IB, IC, IT)                   \
  template <int TRANS_B>                                                   \
  __device__ __forceinline__ void wgmma_m64n##N##k16_rs(                    \
      float(&d)[R], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,    \
      uint64_t b, int accumulate) {                                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k16.f32.bf16.bf16 " DSTR ", {%" IA "}, %" IB             \
                 ", p, 1, 1, %" IT ";\n}"                                  \
                 : OPS                                                     \
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b),             \
                   "r"(accumulate), "n"(TRANS_B));                         \
  }

HOPPER_WGMMA_RS(8, 4, HOPPER_D4, HOPPER_F4(d, 0), "4, %5, %6, %7", "8", "9",
                "10")
HOPPER_WGMMA_RS(16, 8, HOPPER_D8, HOPPER_F8(d, 0), "8, %9, %10, %11", "12",
                "13", "14")
HOPPER_WGMMA_RS(32, 16, HOPPER_D16, HOPPER_F16(d, 0), "16, %17, %18, %19",
                "20", "21", "22")
HOPPER_WGMMA_RS(64, 32, HOPPER_D32, HOPPER_F32(d, 0), "32, %33, %34, %35",
                "36", "37", "38")
HOPPER_WGMMA_RS(128, 64, HOPPER_D64, HOPPER_F64(d, 0), "64, %65, %66, %67",
                "68", "69", "70")
HOPPER_WGMMA_RS(256, 128, HOPPER_D128, HOPPER_F128(d, 0),
                "128, %129, %130, %131", "132", "133", "134")

#undef HOPPER_WGMMA_RS

// ---- device: ldmatrix ------------------------------------------------------

// Four 8 x 8 matrices of 16-bit elements from shared memory, transposed:
// threads 8 j .. 8 j + 7 give the addresses of matrix j's 8 rows (16
// bytes each, 16-byte aligned), and r[j] of thread t holds the elements
// (row 2 (t % 4), column t / 4) in its low half and (row 2 (t % 4) + 1,
// column t / 4) in its high half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same for two matrices (rows from threads 0-15), r[j] as above.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// ---- device: int8 wgmma ---------------------------------------------------

// D (64 x N, int32) = A (64 x 32) * B (32 x N) + (accumulate ? D : 0),
// issued by one warpgroup; A and B int8 in shared memory (descriptors),
// both K-major: the integer wgmma has no transpose, so an int8 operand is
// always K-major. A k-step of 32 int8 is 32 bytes, as 16 bf16 are, so
// desc_sw128 and desc_advance serve as they are. d holds N / 2 int32 a
// thread in the accumulator layout above (row r, r + 8; column 8 j + 2 (t
// % 4) + e % 2). Named wgmma_m64n<N>k32_s8 for N = 8, 16, 32, 64, 128, 256.
#define HOPPER_WGMMA_S8(N, R, DSTR, OPS, IA, IB, IC)                      \
  __device__ __forceinline__ void wgmma_m64n##N##k32_s8(                   \
      int(&d)[R], uint64_t a, uint64_t b, int accumulate) {                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IC ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 "  \
                 DSTR ", %" IA ", %" IB ", p;\n}"                          \
                 : OPS                                                     \
                 : "l"(a), "l"(b), "r"(accumulate));                       \
  }

HOPPER_WGMMA_S8(8, 4, HOPPER_D4, HOPPER_R4(d, 0), "4", "5", "6")
HOPPER_WGMMA_S8(16, 8, HOPPER_D8, HOPPER_R8(d, 0), "8", "9", "10")
HOPPER_WGMMA_S8(32, 16, HOPPER_D16, HOPPER_R16(d, 0), "16", "17", "18")
HOPPER_WGMMA_S8(64, 32, HOPPER_D32, HOPPER_R32(d, 0), "32", "33", "34")
HOPPER_WGMMA_S8(128, 64, HOPPER_D64, HOPPER_R64(d, 0), "64", "65", "66")
HOPPER_WGMMA_S8(256, 128, HOPPER_D128, HOPPER_R128(d, 0), "128", "129",
                "130")

#undef HOPPER_WGMMA_S8

}  // namespace hopper
