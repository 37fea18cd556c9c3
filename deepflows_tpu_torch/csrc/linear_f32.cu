// linear_f32: C = epilogue(A @ B) in true f32 on the CUDA cores, with the
// epilogue none, + bias, relu(+ bias) or tanh(+ bias).
//
// Replaces two TPU kernels of deepflows_tpu/ops/pallas_kernels.py that are
// one tiled product with and without an epilogue: matmul (_matmul_kernel)
// and linear_fused (_linear_kernel: act(x @ w + b), act none, relu or
// tanh).  Both accumulate K in an f32 tile; neither rounds an operand, so
// this kernel uses no tensor cores (they would round f32 to TF32) and sums
// with f32 FMAs.  The TPU kernels zero-pad their operands to tile
// multiples on the host; here the ragged edges of M, N and K are masked in
// the loads (cp.async with a zero source size fills zeros) and stores, and
// the operands are read through their strides, so a transposed view (the
// backward's x^T and w^T) costs no copy.
//
// What bounds it on an H100: the FLOPs, 2·M·N·K at 67 TFLOP/s f32 (2.05 ms
// at 4096^3) for large shapes; the MLP's small layers take a few blocks
// and are bound by launch latency.  Design: a 128 x 128 output tile per
// block of 256 threads, each thread an 8 x 8 register micro-tile split in
// four 4 x 4 quarters 64 rows and columns apart (so a warp's shared-memory
// reads of a k row are contiguous and free of bank conflicts), K in steps
// of 8 through a cp.async double buffer: the next (128 x 8, 8 x 128) pair
// of tiles loads while the current one is multiplied.  The loads walk
// along whichever stride of an operand is 1, so either layout coalesces.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256, PAD = 4;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;  // 0: no read, the destination is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// epilogue: 0 none, 1 + bias, 2 relu(+ bias), 3 tanh(+ bias)
template <int EPI>
__global__ void __launch_bounds__(THREADS)
linear_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K,
                  long long sam, long long sak, long long sbk, long long sbn) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_k_unit = sak == 1, b_n_unit = sbn == 1;

  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = a_k_unit ? (tid & 7) : (tid >> 7) + 2 * r;
      const int mm = a_k_unit ? (tid >> 3) + 32 * r : (tid & 127);
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async4(&As[buf][kk][mm], ok ? A + gm * sam + gk * sak : A, ok);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = b_n_unit ? (tid >> 7) + 2 * r : (tid & 7);
      const int nn = b_n_unit ? (tid & 127) : (tid >> 3) + 32 * r;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      cp_async4(&Bs[buf][kk][nn], ok ? B + gk * sbk + gn * sbn : B, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int tiles = (K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load((t + 1) & 1, (t + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = t & 1;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's load overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= N) continue;
      float y = acc[i][j];
      if (EPI >= 1) y += bias[col];
      if (EPI == 2) y = y < 0.f ? 0.f : y;
      if (EPI == 3) y = tanhf(y);
      C[static_cast<long long>(row) * N + col] = y;
    }
  }
}

}  // namespace

// C (M, N) contiguous = epilogue(A @ B + bias): A (M, K) with strides
// (sam, sak), B (K, N) with strides (sbk, sbn), bias (N,) or null when
// epi is 0.  Returns the launch's cudaError_t; the caller raises if it is
// not 0.
extern "C" int dft_linear_f32(const float* a, const float* b, const float* bias, float* c, int M,
                              int N, int K, long long sam, long long sak, long long sbk,
                              long long sbn, int epi, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case 0:
      linear_f32_kernel<0><<<grid, THREADS, 0, st>>>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn);
      break;
    case 1:
      linear_f32_kernel<1><<<grid, THREADS, 0, st>>>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn);
      break;
    case 2:
      linear_f32_kernel<2><<<grid, THREADS, 0, st>>>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn);
      break;
    case 3:
      linear_f32_kernel<3><<<grid, THREADS, 0, st>>>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
