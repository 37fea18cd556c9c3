// Shared tiling of the two int8 matrix products, int8_matmul.cu and
// w8a8_matmul.cu: out[M, N] = epilogue(sum_k x[m, k] * w[k, n]) with an
// int8 (K, N) row-major weight.
//
// Each block owns a BM x BN tile of the output and loops over K in steps of
// BK.  Per step it stages the x tile (widened to the staging type XS) and
// the int8 weight tile into shared memory.  The weight moves in 16-byte
// loads, one byte per weight: the int8 bytes are all that crosses device
// memory.  It is widened to the accumulator type only when it is read from
// shared memory.  Each thread owns TM x TN outputs of one of KS interleaved
// K slices (k = ks, ks + KS, ...); with KS > 1 the slices are summed through
// shared memory, in a fixed order, after the K loop.  The epilogue functor
// scales, converts and stores one output.  Ragged M, N and K edges are
// masked: out-of-range x and w elements are staged as zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dft {

__device__ __forceinline__ float stage(float v) { return v; }
__device__ __forceinline__ float stage(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int8_t stage(int8_t v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BM_, int BN_, int BK_, int TM_, int TN_, int KS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_, KS = KS_;
  static constexpr int THREADS = (BM / TM) * (BN / TN) * KS;
  static_assert(BN % 16 == 0, "weight rows are staged in 16-byte chunks");
  static_assert(TN == 4, "a thread reads its weights as one 4-byte word");
};

// Decode (M <= 8): all rows in one tile, 32 columns per block so that a
// (1024, 1024) weight still spreads over 32 blocks, and 32 K slices per block.
using Skinny = Tile<8, 32, 256, 8, 4, 32>;
// Prefill and other large M: 64 x 64 output tiles, 4 x 4 outputs per thread.
using Square = Tile<64, 64, 32, 4, 4, 1>;

template <class TL, typename XT, typename XS, typename ACC, class Epilogue>
__global__ void __launch_bounds__(TL::THREADS)
int8_tile_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 int M, int N, int K, int w_vec16, Epilogue epi) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, TM = TL::TM, TN = TL::TN,
                KS = TL::KS, THREADS = TL::THREADS;
  constexpr int NT = BN / TN, MT = BM / TM, XLD = BK + 1;
  constexpr int XS_BYTES = (BM * XLD * (int)sizeof(XS) + 15) / 16 * 16;
  constexpr int TILE_BYTES = XS_BYTES + BK * BN;
  constexpr int RED_BYTES = KS > 1 ? KS * BM * BN * (int)sizeof(ACC) : 0;
  constexpr int SMEM = TILE_BYTES > RED_BYTES ? TILE_BYTES : RED_BYTES;
  __shared__ __align__(16) unsigned char smem[SMEM];
  XS* xs = reinterpret_cast<XS*>(smem);                     // [BM][BK + 1]
  int8_t* ws = reinterpret_cast<int8_t*>(smem + XS_BYTES);  // [BK][BN]

  const int t = threadIdx.x;
  const int tn = t % NT, tm = (t / NT) % MT, ks = t / (NT * MT);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  ACC acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ACC(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = t; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gm = m0 + r, gk = k0 + c;
      xs[r * XLD + c] = (gm < M && gk < K) ? stage(x[(size_t)gm * K + gk]) : XS(0);
    }
    constexpr int CH = BN / 16;
    for (int e = t; e < BK * CH; e += THREADS) {
      const int r = e / CH, c = (e % CH) * 16, gk = k0 + r, gn = n0 + c;
      int4 v = make_int4(0, 0, 0, 0);
      if (gk < K) {
        const int8_t* src = w + (size_t)gk * N + gn;
        if (w_vec16 && gn + 16 <= N) {
          v = __ldg(reinterpret_cast<const int4*>(src));
        } else {
          int8_t* b = reinterpret_cast<int8_t*>(&v);
          for (int j = 0; j < 16; ++j)
            if (gn + j < N) b[j] = src[j];
        }
      }
      *reinterpret_cast<int4*>(ws + r * BN + c) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = ks; kk < BK; kk += KS) {
      ACC a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ACC(xs[(tm * TM + i) * XLD + kk]);
      const char4 q = *reinterpret_cast<const char4*>(ws + kk * BN + tn * TN);
      const ACC b[TN] = {ACC(q.x), ACC(q.y), ACC(q.z), ACC(q.w)};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  if constexpr (KS > 1) {
    ACC* red = reinterpret_cast<ACC*>(smem);  // [KS][BM][BN]
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        red[(ks * BM + tm * TM + i) * BN + tn * TN + j] = acc[i][j];
    __syncthreads();
    for (int e = t; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      ACC s = ACC(0);
      for (int q = 0; q < KS; ++q) s += red[(q * BM + r) * BN + c];
      if (m0 + r < M && n0 + c < N) epi(m0 + r, n0 + c, s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gm = m0 + tm * TM + i, gn = n0 + tn * TN + j;
        if (gm < M && gn < N) epi(gm, gn, acc[i][j]);
      }
  }
}

// Launch the tile kernel with TL's shape over an M x N output.
template <class TL, typename XT, typename XS, typename ACC, class Epilogue>
void launch_tiles(const void* x, const void* w, int M, int N, int K, Epilogue epi,
                  cudaStream_t stream) {
  const dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  int8_tile_kernel<TL, XT, XS, ACC><<<grid, TL::THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w), M, N, K, vec, epi);
}

// Decode-sized M takes the skinny tiles, anything larger the square ones.
template <typename XT, typename XS, typename ACC, class Epilogue>
void launch_int8_product(const void* x, const void* w, int M, int N, int K, Epilogue epi,
                         cudaStream_t stream) {
  if (M <= Skinny::BM)
    launch_tiles<Skinny, XT, XS, ACC>(x, w, M, N, K, epi, stream);
  else
    launch_tiles<Square, XT, XS, ACC>(x, w, M, N, K, epi, stream);
}

}  // namespace dft
