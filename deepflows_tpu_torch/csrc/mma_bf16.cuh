// bf16 tensor-core building blocks shared by flash_attention.cu and
// fused_linear_ce.cu: mma.sync m16n8k16 (bf16 in, f32 accumulate), its
// operands loaded from shared memory with ldmatrix, and cp.async staging.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l = 4 g + t
// holds, of the 16 x 8 f32 accumulator, rows g and g + 8 and columns 2t and
// 2t + 1 — c[0], c[1] in row g and c[2], c[3] in row g + 8.  That is the
// A operand's layout of a 16 x 16 tile split in two 8-column halves, so an
// accumulator pair packs straight into the next product's A operand.
//
// Shared tiles are row-major bf16 with a row stride that is a multiple of
// 8 elements plus 8 (16 bytes of padding): the 8 rows one ldmatrix phase
// reads then start in 8 distinct 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dft {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 and packed, the lower column in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator n-tiles 2kk and 2kk + 1 (16 columns) as an A operand
__device__ __forceinline__ void pack_a(uint32_t (&r)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  r[0] = pack(c0[0], c0[1]);
  r[1] = pack(c0[2], c0[3]);
  r[2] = pack(c1[0], c1[1]);
  r[3] = pack(c1[2], c1[3]);
}

// The A operand (16 x 16) at (r0, c0) of a row-major [m][k] tile: lane l
// gives row r0 + l % 8 + 8 (j & 1), column c0 + 8 (j >> 1), j = l / 8.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* t, int ld, int r0, int c0) {
  const int l = threadIdx.x % 32, j = l / 8;
  ldsm_x4(r, t + (r0 + l % 8 + (j & 1) * 8) * ld + c0 + (j >> 1) * 8);
}

// The A operand at (m0, k0) of the transpose of a row-major [k][m] tile.
__device__ __forceinline__ void load_a_t(uint32_t (&r)[4], const bf16* t, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x % 32, j = l / 8;
  ldsm_x4_t(r, t + (k0 + l % 8 + (j >> 1) * 8) * ld + m0 + (j & 1) * 8);
}

// The B operands of two n-tiles (n0 and n0 + 8, k0 .. k0 + 15) from a
// row-major [n][k] tile: r[0], r[1] for n0 and r[2], r[3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* t, int ld, int n0,
                                          int k0) {
  const int l = threadIdx.x % 32, j = l / 8;
  ldsm_x4(r, t + (n0 + l % 8 + (j >> 1) * 8) * ld + k0 + (j & 1) * 8);
}

// The same from a row-major [k][n] tile, through ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* t, int ld, int k0,
                                          int n0) {
  const int l = threadIdx.x % 32, j = l / 8;
  ldsm_x4_t(r, t + (k0 + l % 8 + (j & 1) * 8) * ld + n0 + (j >> 1) * 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most the newest committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The ROWS x COLS tile at (row0, col0) of a row-major (nrows, ncols) bf16
// matrix with row stride lsrc into dst (row stride ldst), zero outside the
// matrix.  With `vec` (16-byte aligned rows) whole 8-element chunks go by
// cp.async and land after the next commit and wait; the rest by plain loads.
// stage_chunk stages chunk e (8 elements, COLS / 8 a row) of the tile.
template <int COLS>
__device__ __forceinline__ void stage_chunk(bf16* dst, int ldst, const bf16* src, long long lsrc,
                                            int row0, int col0, int nrows, int ncols, int vec,
                                            int e) {
  constexpr int CH = COLS / 8;
  const int r = e / CH, c = (e % CH) * 8, gr = row0 + r, gc = col0 + c;
  bf16* d = dst + r * ldst + c;
  if (vec && gr < nrows && gc + 8 <= ncols) {
    cp_async16(d, src + (long long)gr * lsrc + gc);
  } else {
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < nrows) {
      bf16* b = reinterpret_cast<bf16*>(&val);
      const bf16* p = src + (long long)gr * lsrc + gc;
      for (int j = 0; j < 8; ++j)
        if (gc + j < ncols) b[j] = p[j];
    }
    *reinterpret_cast<uint4*>(d) = val;
  }
}

template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, int ldst, const bf16* src, long long lsrc,
                                           int row0, int col0, int nrows, int ncols, int vec) {
  for (int e = threadIdx.x; e < ROWS * (COLS / 8); e += THREADS)
    stage_chunk<COLS>(dst, ldst, src, lsrc, row0, col0, nrows, ncols, vec, e);
}

__device__ __forceinline__ float quad_max(float v) {  // over the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma
}  // namespace dft
