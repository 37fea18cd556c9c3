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
// backward's x^T and w^T) costs no copy.  The loads walk along whichever
// stride of an operand is 1, so either layout coalesces.
//
// What bounds it on an H100, and the two paths the wrapper's plan
// (ops/linear.py _linear_plan) chooses between:
//
// - Large products (a 128 x 128 grid of at least 132 blocks, such as
//   4096^3): the FLOPs, 2·M·N·K at 67 TFLOP/s f32 (2.05 ms at 4096^3).  A
//   128 x 128 output tile per block of 256 threads, each thread an 8 x 8
//   register micro-tile split in four 4 x 4 quarters 64 rows and columns
//   apart (so a warp's shared-memory reads of a k row are contiguous and
//   free of bank conflicts), K in steps of 8 through a cp.async double
//   buffer.
// - Every other product (the MLP's layers and their backward products):
//   latency.  At (256, 784) @ (784, 100) the 128 x 128 tile launches 2
//   blocks on 132 SMs, and each walks K in 98 serial steps of a copy and
//   two barriers.  Here a block owns a 32 x 32 output tile (128 threads,
//   4 x 2 outputs each) and a chunk of K (a multiple of 8); the plan takes
//   the fewest K splits (at most 16, of at least 16 rows) that bring the
//   grid to 132 blocks.
//   The chunk streams in steps of 32 through a 4-stage cp.async ring, so
//   three steps' copies are in flight while one is multiplied.  The K
//   splits of a tile are one thread block cluster: each block leaves its
//   32 x 32 sums in shared memory, and after a cluster barrier block r
//   finishes rows of the tile (128 outputs a turn), adding the splits'
//   sums through distributed shared memory in split order, then bias and
//   activation, once, after the whole K sum, as the TPU kernel applies
//   them at its last k step.  One launch a call, no workspace, no
//   counter, and the same bits from two calls.
#include <cuda_runtime.h>

#include <cooperative_groups.h>

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


// The small-product path: a 32 x 32 output tile and one K chunk a block,
// a tile's K splits one cluster (gridDim.z blocks along z).
namespace small {

constexpr int BM = 32, BN = 32, BK = 32, STAGES = 4, THREADS = 128, MAX_SPLITS = 16;
constexpr int LD = BM + 4;  // shared row stride (BM == BN): float4 rows stay 16-byte aligned

template <int EPI>
__global__ void __launch_bounds__(THREADS)
linear_f32_split(const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K,
                 int chunk, long long sam, long long sak, long long sbk, long long sbn) {
  namespace cg = cooperative_groups;
  __shared__ __align__(16) float As[STAGES][BK][LD];
  __shared__ __align__(16) float Bs[STAGES][BK][LD];
  __shared__ __align__(16) float sums[BM * BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // columns 2 tx, 2 tx + 1; rows 4 ty .. 4 ty + 3
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int kbeg = split * chunk, kend = min(K, kbeg + chunk);
  const int steps = (kend - kbeg + BK - 1) / BK;
  const bool a_k_unit = sak == 1, b_n_unit = sbn == 1;

  // step s of the chunk into stage `buf`: 32 x 32 of A and of B, 8 copies
  // a thread each, along the operand's unit stride
  auto load = [&](int buf, int s) {
    const int k0 = kbeg + s * BK;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int kk = a_k_unit ? (tid & 31) : (tid >> 5) + 4 * r;
      const int mm = a_k_unit ? (tid >> 5) + 4 * r : (tid & 31);
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < M && gk < kend;
      cp_async4(&As[buf][kk][mm], ok ? A + gm * sam + gk * sak : A, ok);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int kk = b_n_unit ? (tid >> 5) + 4 * r : (tid & 31);
      const int nn = b_n_unit ? (tid & 31) : (tid >> 5) + 4 * r;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < kend && gn < N;
      cp_async4(&Bs[buf][kk][nn], ok ? B + gk * sbk + gn * sbn : B, ok);
    }
  };

  float acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed
    __syncthreads();              // ... for every thread; step s - 1's stage is free
    if (s + STAGES - 1 < steps) load((s + STAGES - 1) % STAGES, s + STAGES - 1);
    cp_async_commit();
    const int buf = s % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float2 b = *reinterpret_cast<const float2*>(&Bs[buf][kk][tx * 2]);
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
      acc[2][0] = fmaf(a.z, b.x, acc[2][0]);
      acc[2][1] = fmaf(a.z, b.y, acc[2][1]);
      acc[3][0] = fmaf(a.w, b.x, acc[3][0]);
      acc[3][1] = fmaf(a.w, b.y, acc[3][1]);
    }
  }
  cp_async_wait<0>();

  auto finish = [&](int e, float y) {  // output e of the tile, its whole K sum
    const int row = m0 + e / BN, col = n0 + e % BN;
    if (row >= M || col >= N) return;
    if (EPI >= 1) y += bias[col];
    if (EPI == 2) y = y < 0.f ? 0.f : y;
    if (EPI == 3) y = tanhf(y);
    C[static_cast<long long>(row) * N + col] = y;
  };
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) finish((ty * 4 + i) * BN + tx * 2 + j, acc[i][j]);
    return;
  }
  // The splits' sums meet in distributed shared memory: block r finishes
  // outputs [128 (r + q splits), + 128) for q = 0, 1, ..., adding every
  // split's sum in split order.
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float2*>(&sums[(ty * 4 + i) * BN + tx * 2]) = make_float2(acc[i][0], acc[i][1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's sums are in place
  for (int e = split * THREADS + tid; e < BM * BN; e += splits * THREADS) {
    float y = 0.f;
    for (int r = 0; r < splits; ++r) y += *cluster.map_shared_rank(&sums[e], r);
    finish(e, y);
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <int EPI>
cudaError_t launch(const float* a, const float* b, const float* bias, float* c, int M, int N,
                   int K, int chunk, int splits, long long sam, long long sak, long long sbk,
                   long long sbn, cudaStream_t st) {
  auto kernel = linear_f32_split<EPI>;
  if (splits > 8) {  // a cluster past the portable 8 blocks, on the current card
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, b, bias, c, M, N, K, chunk, sam, sak, sbk, sbn);
}

}  // namespace small

template <int EPI>
cudaError_t launch_plan(const float* a, const float* b, const float* bias, float* c, int M,
                        int N, int K, long long sam, long long sak, long long sbk, long long sbn,
                        int tile, int chunk, int splits, cudaStream_t st) {
  if (tile == BM) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    linear_f32_kernel<EPI><<<grid, THREADS, 0, st>>>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn);
    return cudaGetLastError();
  }
  const cudaError_t e =
      small::launch<EPI>(a, b, bias, c, M, N, K, chunk, splits, sam, sak, sbk, sbn, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// C (M, N) contiguous = epilogue(A @ B + bias): A (M, K) with strides
// (sam, sak), B (K, N) with strides (sbk, sbn), bias (N,) or null when
// epi is 0.  The plan (ops/linear.py _linear_plan): tile 128 with chunk K
// and 1 split, or tile 32 with K split into `splits` chunks of `chunk`
// rows (a multiple of 8), at most 16; any other plan is refused with
// cudaErrorInvalidValue.  Returns the launch's cudaError_t; the caller
// raises if it is not 0.
extern "C" int dft_linear_f32(const float* a, const float* b, const float* bias, float* c, int M,
                              int N, int K, long long sam, long long sak, long long sbk,
                              long long sbn, int epi, int tile, int chunk, int splits,
                              void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool large = tile == BM && splits == 1 && chunk == K;
  const bool split = tile == small::BM && splits >= 1 && splits <= small::MAX_SPLITS &&
                     chunk >= 8 && chunk % 8 == 0 && splits == (K + chunk - 1) / chunk;
  if (!large && !split) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (epi) {
    case 0:
      e = launch_plan<0>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, tile, chunk, splits, st);
      break;
    case 1:
      e = launch_plan<1>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, tile, chunk, splits, st);
      break;
    case 2:
      e = launch_plan<2>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, tile, chunk, splits, st);
      break;
    case 3:
      e = launch_plan<3>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, tile, chunk, splits, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
