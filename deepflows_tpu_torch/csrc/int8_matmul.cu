// int8_matmul: out = x @ (wq * scale[col]), weight-only int8 product.
//
// Replaces the TPU kernel deepflows_tpu/ops/pallas_kernels.py int8_matmul
// (_int8_matmul_kernel): x (M, K) f32 or bf16, wq (K, N) int8, scale (N,) f32,
// out (M, N) f32 or bf16.  The accumulator is f32 and the per-column scale
// multiplies it once, after the whole K sum.
//
// What bounds it on an H100: at decode M <= 8 the work is a few FLOPs per
// weight byte, so the floor is the weight bytes over 3.35 TB/s (a
// (1024, 4096) weight is 4 MiB: 1.25 us); at the decoder's shapes each
// call's fixed cost (launch, the first trip to device memory, the hand-over
// of the K splits) is larger.  At prefill M (1536 at B 8) it is bound by
// operations: 2 M K N over 989 TFLOP/s in bf16 (three times that for f32 x,
// which runs three bf16 products).  The weight streams once, as int8, and
// is widened only on chip, never written back widened (the point of the
// TPU kernel).  Both designs are in int8_tile.cuh.  Decode M takes the
// split-K stream: (32-column tile, K chunk) blocks, at least 264 at every
// decoder shape, a tile's K splits one cluster; every warp keeps its whole
// share of the weight in flight as 16-byte cp.async copies and multiplies
// each 64-row step as it lands on the tensor cores.  Prefill M takes the
// tensor-core tile: BM x 128 outputs a block (the plan's BM fills the 132
// SMs), a 3-stage cp.async ring of 64-row K steps, mma.sync m16n8k16.
// Both widen int8 -> bf16 exactly and take bf16 x as it is and f32 x as
// three exact bf16 parts, so the products are exact and the sums f32, in a
// fixed order: two calls give the same bits.  The TPU kernel's padding of
// every operand to its 128/256 tiles is dropped; the kernel masks ragged
// edges itself.  PERF.md holds its measured times.
#include "int8_tile.cuh"

namespace {

template <typename OT>
struct ScaleColumns {
  const float* scale;
  OT* out;
  int N;
  using Scales = float;  // loaded ahead of the sum where the kernel can
  __device__ __forceinline__ float load(int, int n) const { return scale[n]; }
  __device__ __forceinline__ void store(int m, int n, float acc, float s) const {
    out[(size_t)m * N + n] = dft::from_float<OT>(acc * s);
  }
  // out[m, n .. n + 7], the columns below N (prefill tile)
  __device__ __forceinline__ void store8(int m, int n, const float (&acc)[8]) const {
    alignas(16) OT v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = dft::from_float<OT>(n + j < N ? acc[j] * __ldg(scale + n + j) : 0.f);
    dft::store_row8(out + (size_t)m * N, n, N, v);
  }
};

template <typename XT, typename OT>
cudaError_t run(const void* x, const void* wq, const void* scale, void* out, int M, int N,
                int K, const dft::Plan& plan, cudaStream_t stream) {
  const ScaleColumns<OT> epi{static_cast<const float*>(scale), static_cast<OT*>(out), N};
  return dft::launch_int8_product<XT, float>(x, wq, M, N, K, plan, epi, stream);
}

}  // namespace

// chunk and splits are the decode plan (ops/quant.py _decode_plan), tile_m
// the prefill plan (_prefill_plan), the other zero.  Returns
// cudaErrorInvalidValue for a plan the kernel does not take, else the
// launch's error; the caller raises if it is not 0.
extern "C" int dft_int8_matmul(const void* x, int x_bf16, const void* wq,
                               const void* scale, void* out, int out_bf16, int M,
                               int N, int K, int chunk, int splits,
                               int tile_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dft::Plan plan{chunk, splits, tile_m};
  cudaError_t rc;
  if (x_bf16) {
    if (out_bf16)
      rc = run<__nv_bfloat16, __nv_bfloat16>(x, wq, scale, out, M, N, K, plan, s);
    else
      rc = run<__nv_bfloat16, float>(x, wq, scale, out, M, N, K, plan, s);
  } else {
    if (out_bf16)
      rc = run<float, __nv_bfloat16>(x, wq, scale, out, M, N, K, plan, s);
    else
      rc = run<float, float>(x, wq, scale, out, M, N, K, plan, s);
  }
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}
