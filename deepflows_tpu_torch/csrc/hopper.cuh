// Hopper (sm_90a) building blocks: TMA tensor maps and loads, mbarriers,
// wgmma from shared memory and from registers, and setmaxnreg.  Shared by
// the kernels fed from a TMA ring: flash_attention.cu's bf16 forward and
// backward, fused_linear_ce.cu's bf16 forward and backward and
// int8_tile.cuh's wgmma prefill (bf16 x, and s8 x for w8a8), and
// linear_f32.cu's large f32 tile (TMA and mbarriers only).
//
// Shared-memory tiles are in the layout a TMA load with the 128-byte swizzle
// writes: rows of 64 bf16 (128 bytes), the 16-byte chunks of row r XOR-ed
// with r % 8, each 8-row group 1024 bytes, and every tile 1024-byte aligned.
// A tile wider than 64 elements is stored as 64-wide column blocks, one TMA
// box each, one after the other.
//
// wgmma's operands in that layout (PTX ISA, "Matrix Descriptor Format";
// CUTLASS's canonical GMMA layouts):
// - K-major (the reduced axis contiguous, as Q and K of attention): the
//   descriptor's stride byte offset is 1024 (one 8-row group to the next),
//   the leading byte offset is unused (16), and a step of 16 along K within
//   a 64-wide block adds 32 bytes to the start address.
// - MN-major (the output axis contiguous, as V in P V): stride byte offset
//   1024 (8 rows of K to the next 8), leading byte offset the size of one
//   64-wide column block (the next 64 output columns); a step of 16 along
//   K adds 16 rows (2048 bytes).  wgmma reads it with the transpose-B bit.
//
// Accumulator layout of wgmma m64nNk16 (f32) and m64nNk32 (s32): thread t
// of the warpgroup, warp w = t / 32, lane l = 4 g + q, holds d[4 j + 0..1]
// at row 16 w + g, columns 8 j + 2 q and + 1, and d[4 j + 2..3] at row
// 16 w + g + 8.  A register A operand (m64k16, bf16) has mma.m16n8k16's A
// layout per warp, so accumulator n-blocks 2 kk and 2 kk + 1, rounded and
// packed in pairs, are the A operand of K step kk of the next product.  An
// 8-bit register A operand (m64k32, s8) has mma.m16n8k32's: a0 holds row
// 16 w + g at k 4 q .. 4 q + 3 (byte 0 the lowest k), a1 row 16 w + g + 8
// there, a2 and a3 the same rows at k 16 + 4 q .. 16 + 4 q + 3 (CUTLASS's
// ALayout_64x32 of SM90_64xNx32_S32S8S8_RS_TN).  8-bit wgmma takes both
// operands K-major only; a K-major 8-bit tile under the 128-byte swizzle
// has rows of 128 elements, and a step of 32 along K adds 32 bytes, as a
// bf16 step of 16 does.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dft {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival, and `bytes` more to come from TMA loads that signal `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------- TMA
// The box at (c0, c1, c2, c3) of a rank-4 tensor map into dst; completion
// is counted in bytes on `bar`.  Elements outside the tensor arrive as 0
// and are counted too.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from src in global memory to dst, both 16-byte
// aligned, without a tensor map; completion is counted on `bar` as
// tma_load_4d's.  (A rank-1 tensor map's box must also start 16-byte
// aligned: one that did not stopped the kernel with an illegal
// instruction.)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// The box at (c0, c1) of a rank-2 tensor map, as tma_load_4d
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------- registers
// A warpgroup gives up (dec) or claims (inc) registers; all 128 threads of
// it execute the instruction.  The kernel's roles must be one if / else
// that never reconverges, or ptxas ignores it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled operand starting at p (see above for
// the two offsets); adding (bytes >> 4) to it moves the start address.
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// before the first wgmma, and after registers that a wgmma reads or
// accumulates were written by other instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are in flight (groups finish in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that a wgmma
// in flight accumulates or reads across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define DFT_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define DFT_D32 DFT_D8(0), DFT_D8(8), DFT_D8(16), DFT_D8(24)
#define DFT_D64 DFT_D32, DFT_D8(32), DFT_D8(40), DFT_D8(48), DFT_D8(56)
#define DFT_I8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define DFT_I32 DFT_I8(0), DFT_I8(8), DFT_I8(16), DFT_I8(24)
#define DFT_I64 DFT_I32, DFT_I8(32), DFT_I8(40), DFT_I8(48), DFT_I8(56)
#define DFT_R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DFT_R64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N, f32) = A (64 x 16, bf16, shared memory; TRANS_A 0: K-major,
// 1: MN-major) B (16 x N, bf16, shared memory; TRANS_B 0: K-major, 1:
// MN-major) + (scale_d ? d : 0)
template <int N, int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DFT_R32
        ", %32, %33, p, 1, 1, %36, %35;\n}\n"
        : DFT_D32
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DFT_R64
        ", %64, %65, p, 1, 1, %68, %67;\n}\n"
        : DFT_D64
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }
}

// the same with A (64 x 16, bf16) from registers, a0..a3 in
// mma.m16n8k16's A layout per warp
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DFT_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : DFT_D32
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DFT_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : DFT_D64
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
}

// the same for 8-bit operands: d (64 x N, s32, exact) = A (64 x 32, s8,
// registers, a0..a3 as the head of this file says) B (32 x N, s8, shared
// memory, K-major: 8-bit wgmma takes no transpose) + (scale_d ? d : 0)
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(int (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  static_assert(TRANS_B == 0, "8-bit wgmma reads B K-major only");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " DFT_R32
        ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : DFT_I32
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " DFT_R64
        ", {%64, %65, %66, %67}, %68, p;\n}\n"
        : DFT_I64
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
  }
}

#undef DFT_D8
#undef DFT_D32
#undef DFT_D64
#undef DFT_I8
#undef DFT_I32
#undef DFT_I64
#undef DFT_R32
#undef DFT_R64

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled is a driver function.  The kernels' libraries link
// only the CUDA runtime (ops/_build.py builds them without -lcuda, and the
// unversioned libcuda.so that -lcuda needs is not on every machine's link
// path), so it is reached through the runtime's driver entry point, once.
// From CUDA 12.5 on that lookup takes the driver API version it wants;
// CUDA 13 keeps only that form.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A rank-4 bf16 tensor map with the 128-byte swizzle: dims innermost first,
// byte strides of dims 1..3 (multiples of 16), a box of (64, rows, 1, 1).
// Returns false if the driver refuses it.
inline bool encode_bf16_4d(CUtensorMap* map, const void* base, const long long* dims,
                           const long long* byte_strides, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2],
                             (cuuint64_t)dims[3]};
  const cuuint64_t stride[3] = {(cuuint64_t)byte_strides[0], (cuuint64_t)byte_strides[1],
                                (cuuint64_t)byte_strides[2]};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dim, stride, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A rank-2 f32 tensor map with the 128-byte swizzle: rows of `inner`
// elements (unit stride), `outer` rows `row_bytes` apart (a multiple of
// 16), boxes of 32 x `rows` (a box row is 128 bytes).  Returns false if
// cuTensorMapEncodeTiled refuses it.
inline bool encode_f32_2d(CUtensorMap* map, const void* base, long long inner, long long outer,
                          long long row_bytes, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t stride[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {32, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dim, stride, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A rank-2 uint8 tensor map with the 128-byte swizzle: rows of `inner`
// bytes (unit stride), `outer` rows `row_bytes` apart (a multiple of 16),
// boxes of 128 x `rows` (a box row is 128 bytes; the int8 weight, and
// w8a8's int8 x, of int8_tile.cuh's wgmma prefill).  Returns false if
// cuTensorMapEncodeTiled refuses it.
inline bool encode_u8_2d(CUtensorMap* map, const void* base, long long inner, long long outer,
                         long long row_bytes, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t stride[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {128, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dim, stride, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace dft
