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
// What bounds it on an H100: at decode M = 8 the floor is the weight bytes
// over 3.35 TB/s, as for int8_matmul; the activation bytes are 1/N of them.
// The design shares int8_matmul's tiling (int8_tile.cuh): 16-byte int8
// weight loads into shared memory, decode-sized M on 32-column blocks with
// the K sum split over 32 thread slices, ragged edges masked in the kernel
// instead of the TPU kernel's padding to 128/256/512 tiles and its
// 128-lane row-scale pad.
//
// This first kernel multiplies and adds one int8 pair at a time on the CUDA
// cores.  __dp4a (four int8 products per instruction) and mma.sync s8 tensor
// cores with s32 accumulation are later work; PERF.md holds its measured
// times.
#include "int8_tile.cuh"

namespace {

template <typename OT>
struct ScaleRowsColumns {
  const float* sx;
  const float* sw;
  OT* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx[m]), sw[n]);
    out[(size_t)m * N + n] = dft::from_float<OT>(v);
  }
};

template <typename OT>
void run(const void* xq, const void* sx, const void* wq, const void* sw, void* out,
         int M, int N, int K, cudaStream_t stream) {
  const ScaleRowsColumns<OT> epi{static_cast<const float*>(sx),
                                 static_cast<const float*>(sw), static_cast<OT*>(out), N};
  dft::launch_int8_product<int8_t, int8_t, int>(xq, wq, M, N, K, epi, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if it is not 0.
extern "C" int dft_w8a8_matmul(const void* xq, const void* sx, const void* wq,
                               const void* sw, void* out, int out_bf16, int M, int N,
                               int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    run<__nv_bfloat16>(xq, sx, wq, sw, out, M, N, K, s);
  else
    run<float>(xq, sx, wq, sw, out, M, N, K, s);
  return static_cast<int>(cudaGetLastError());
}
