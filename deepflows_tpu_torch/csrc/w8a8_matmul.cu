// w8a8_matmul: out = (xq * sx[row]) @ (wq * sw[col]), int8 activations and
// int8 weights with exact int32 accumulation.
//
// Replaces the TPU kernel deepflows_tpu/ops/pallas_kernels.py w8a8_matmul
// (_w8a8_kernel): xq (M, K) int8, sx (M,) f32, wq (K, N) int8, sw (N,) f32,
// out (M, N) f32 or bf16.  The epilogue computes float(acc) * sx[row] *
// sw[col] in that order, as the TPU kernel does, so the result is
// reproducible bit for bit (the plain twin in ops/quant.py agrees exactly).
// The wrapper rejects K * 127^2 >= 2^31, where int32 could overflow.
//
// What bounds it on an H100: at decode M <= 8 the floor is the weight bytes
// over 3.35 TB/s, as for int8_matmul (the activation bytes are 1/N of
// them), and at the decoder's shapes each call's fixed cost is larger.  At
// prefill M (1536 at B 8) it is bound by operations: 2 M K N over 1,979
// TOPS in int8.  Decode M shares int8_matmul's split-K stream
// (int8_tile.cuh): 32-column tiles by K chunks, at least 264 blocks at
// every decoder shape, a tile's K splits one cluster, every warp's share
// of the weight in flight at once as 16-byte cp.async copies; a 4 x 4 byte
// transpose of each quad of K rows feeds __dp4a (exact int32 sums), and
// the splits' sums meet in distributed shared memory, so they stay exact.
// Prefill M shares int8_matmul's tensor-core tile: BM x 128 outputs a
// block, a 3-stage cp.async ring of 64-row K steps, x read with ldmatrix
// as it is and the weight through the same byte transpose as the B
// operand of mma.sync m16n8k32 s8 x s8 -> s32, exact.  Ragged edges are
// masked in the kernel instead of the TPU kernel's padding to 128/256/512
// tiles and its 128-lane row-scale pad.  PERF.md holds its measured times.
#include "int8_tile.cuh"

namespace {

template <typename OT>
struct ScaleRowsColumns {
  const float* sx;
  const float* sw;
  OT* out;
  int N;
  using Scales = float2;  // (sx[m], sw[n]), loaded ahead of the sum where the kernel can
  __device__ __forceinline__ float2 load(int m, int n) const { return make_float2(sx[m], sw[n]); }
  __device__ __forceinline__ void store(int m, int n, int acc, float2 s) const {
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s.x), s.y);
    out[(size_t)m * N + n] = dft::from_float<OT>(v);
  }
  // out[m, n .. n + 7], the columns below N (prefill tile)
  __device__ __forceinline__ void store8(int m, int n, const int (&acc)[8]) const {
    const float s = __ldg(sx + m);
    alignas(16) OT v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = dft::from_float<OT>(
          n + j < N ? __fmul_rn(__fmul_rn(__int2float_rn(acc[j]), s), __ldg(sw + n + j)) : 0.f);
    dft::store_row8(out + (size_t)m * N, n, N, v);
  }
};

template <typename OT>
cudaError_t run(const void* xq, const void* sx, const void* wq, const void* sw, void* out,
                int M, int N, int K, const dft::Plan& plan, cudaStream_t stream) {
  const ScaleRowsColumns<OT> epi{static_cast<const float*>(sx),
                                 static_cast<const float*>(sw), static_cast<OT*>(out), N};
  return dft::launch_int8_product<int8_t, int>(xq, wq, M, N, K, plan, epi, stream);
}

}  // namespace

// chunk and splits are the decode plan (ops/quant.py _decode_plan), tile_m
// the prefill plan (_prefill_plan), the other zero.  Returns
// cudaErrorInvalidValue for a plan the kernel does not take, else the
// launch's error; the caller raises if it is not 0.
extern "C" int dft_w8a8_matmul(const void* xq, const void* sx, const void* wq,
                               const void* sw, void* out, int out_bf16, int M, int N,
                               int K, int chunk, int splits, int tile_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dft::Plan plan{chunk, splits, tile_m};
  const cudaError_t rc = out_bf16 ? run<__nv_bfloat16>(xq, sx, wq, sw, out, M, N, K, plan, s)
                                  : run<float>(xq, sx, wq, sw, out, M, N, K, plan, s);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
