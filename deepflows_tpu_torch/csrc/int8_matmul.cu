// int8_matmul: out = x @ (wq * scale[col]), weight-only int8 product.
//
// Replaces the TPU kernel deepflows_tpu/ops/pallas_kernels.py int8_matmul
// (_int8_matmul_kernel): x (M, K) f32 or bf16, wq (K, N) int8, scale (N,) f32,
// out (M, N) f32 or bf16.  The accumulator is f32 and the per-column scale
// multiplies it once, after the whole K sum.
//
// What bounds it on an H100: at decode M = 8 the work is a few FLOPs per
// weight byte, so the floor is the weight bytes over 3.35 TB/s (a
// (1024, 4096) weight is 4 MiB: 1.25 us).  The design streams the weight
// once, as int8, in 16-byte loads into shared memory and widens it there,
// never writing a widened copy to device memory (the point of the TPU
// kernel).  Decode M takes the Skinny tiles of int8_tile.cuh: 32-column
// blocks with the K sum split over 32 thread slices, so that narrow weights
// still occupy several dozen SMs.  The TPU kernel's padding of every operand
// to its 128/256 tiles is dropped; the kernel masks ragged edges itself.
//
// This first kernel is simple and not yet fast: a load-then-compute loop
// with no double buffering, FMA on the CUDA cores, no split of K across
// blocks.  Pipelining the weight stream (cp.async or TMA) and split-K for
// narrow N are later work; PERF.md holds its measured times.
#include "int8_tile.cuh"

namespace {

template <typename OT>
struct ScaleColumns {
  const float* scale;
  OT* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = dft::from_float<OT>(acc * scale[n]);
  }
};

template <typename XT, typename OT>
void run(const void* x, const void* wq, const void* scale, void* out, int M, int N,
         int K, cudaStream_t stream) {
  const ScaleColumns<OT> epi{static_cast<const float*>(scale), static_cast<OT*>(out), N};
  dft::launch_int8_product<XT, float, float>(x, wq, M, N, K, epi, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is not 0.
extern "C" int dft_int8_matmul(const void* x, int x_bf16, const void* wq,
                               const void* scale, void* out, int out_bf16, int M,
                               int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (out_bf16)
      run<__nv_bfloat16, __nv_bfloat16>(x, wq, scale, out, M, N, K, s);
    else
      run<__nv_bfloat16, float>(x, wq, scale, out, M, N, K, s);
  } else {
    if (out_bf16)
      run<float, __nv_bfloat16>(x, wq, scale, out, M, N, K, s);
    else
      run<float, float>(x, wq, scale, out, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
