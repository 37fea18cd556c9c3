// Shared tiling of the two int8 matrix products, int8_matmul.cu and
// w8a8_matmul.cu: out[M, N] = epilogue(sum_k x[m, k] * w[k, n]) with an
// int8 (K, N) row-major weight.  It replaces the K loops of the TPU kernels
// _int8_matmul_kernel and _w8a8_kernel (deepflows_tpu/ops/pallas_kernels.py).
// The int8 weight bytes are all that crosses device memory: it is widened
// only on chip.  Two designs, chosen by the shape.
//
// Decode (M <= 8, K <= 8192; int8_decode_kernel): a weight stream.  The
// grid is (column tiles of 32, K splits) as the wrapper's plan
// (ops/quant.py _decode_plan) sets it, at least 264 blocks on the 132 SMs
// at every decoder shape, and a tile's splits (at most 16) are one thread
// block cluster.  A block owns a 32-column tile and a chunk of at most 512
// K rows.  Each warp streams its own quarter of the chunk as 16-byte
// cp.async copies into shared memory, one group per 64-row step, all in
// flight at once (up to 16 KB a block, 40-60 KB an SM), and takes each
// step as it lands: no block barrier in the K loop.  x's rows for the
// chunk are staged once, meanwhile.  bf16 and f32 x run on the tensor cores
// (mma.sync m16n8k16 bf16 with f32 sums, int8 -> bf16 exact by a bit trick,
// f32 x split exactly into three bf16); int8 x runs __dp4a on the CUDA cores
// with exact int32 sums.  Each block sends its block sums through
// distributed shared memory to the block of its cluster that finishes
// them, with an arrival on that block's barrier; the finishing block adds
// the splits in split order and applies the epilogue.  The order of every
// sum is fixed, so a call gives the same bits every time; there is no
// workspace and no counter, and a call is one launch.  What bounds it: at
// the decoder's shapes not the weight bytes (1-8 MB, 0.3-2.5 us at 3.35
// TB/s) but each call's fixed cost: the launch (about 1 us), the first
// trip to device memory, and the cluster's hand-over at the end.
//
// Prefill and every other call (M > 8, or K > 8192 at any M;
// int8_prefill_kernel): bound by operations, not bytes.  At the decoder's
// prefill shapes (M 1536) a call does 2 M K N = 3.2-12.9 GFLOP on 1-4 MB of
// weight, 3.3-13 us at 989 TFLOP/s (bf16) or 1,979 TOPS (int8) against
// 1-4 us of bytes, so only the tensor cores can approach the card's rate.
// Each block owns a BM x 128 output tile (BM 128, 64 or 32, as the
// wrapper's plan, ops/quant.py _prefill_plan, chooses so that the grid
// fills the 132 SMs) and each of its warps a 64 x 32 part (BM 128: 8
// warps; BM 64: 4) or 32 x 32 (BM 32: 4 warps).  A warp widens its B
// fragments once for all its 16-row tiles, so its tile stays tall (8-warp
// blocks of 32 x 32 and 16 x 32 warp tiles at BM 64 and 32 were slower per
// call in a tile sweep on the H100, PERF.md section 6).  K goes
// in steps of 64 rows through a 3-stage ring of 16-byte cp.async copies,
// zero-filled past the M, N and K edges: the copies of steps s + 1 and
// s + 2 are in flight while step s multiplies, with one block barrier a
// step.  Only int8 weight bytes cross device memory.  The weight tile is
// kept as it arrives, (K, N) bytes, with each row's four 32-byte segments
// swizzled by row so that the reads below hit 32 distinct banks; a thread
// reads one word (4 columns) from each of 4 K rows and a 4 x 4 byte
// transpose gives it those columns' 4 K values, which is the B fragment of
// mma.sync: as it is for int8 x (m16n8k32 s8 -> s32, exact), widened to
// bf16 exactly (the 0x4B000000 trick) for float x (m16n8k16 bf16 -> f32,
// exact products, f32 sums).  The 4 columns a thread reads are column g of
// 4 n8 tiles, so its 8 sums of a row are 8 adjacent columns, stored as one
// 16- or 32-byte write.  x is staged as it is and read with ldmatrix (bf16
// and int8) or, for f32 x, as float pairs split into the three exact bf16
// parts of split3, one product each, so the products are exactly f32's
// (no TF32).  One block sums each output over all of K in a fixed order:
// two calls give the same bits.  A weight or N that is not 16-byte aligned
// and x rows whose bytes are not a multiple of 16 take plain loads into
// the same ring.  Ragged M, N and K edges are masked in both designs:
// out-of-range elements are zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace dft {

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v[j] to row[n + j] for the columns below N: one 16-byte store per 16
// bytes where the row's length allows (the prefill tile's epilogue; v and
// row + n 16-byte aligned when n is a multiple of 8).
template <typename OT>
__device__ __forceinline__ void store_row8(OT* row, int n, int N, const OT (&v)[8]) {
  OT* dst = row + n;
  if (n + 8 <= N && (N * sizeof(OT)) % 16 == 0) {
#pragma unroll
    for (int q = 0; q < (int)sizeof(v) / 16; ++q)
      reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(v)[q];
  } else {
    for (int j = 0; j < 8 && n + j < N; ++j) dst[j] = v[j];
  }
}

namespace decode {
constexpr int MAX_M = 8;        // rows the decode kernel takes
constexpr int MAX_SPLITS = 16;  // K splits of a column tile: the blocks of one cluster
constexpr int BN = 32;          // columns of a block's tile: 8 words of 4 bytes
constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int STEP = 64;        // K rows the 4 warps stream at once, 16 each
constexpr int CHUNK_MAX = 512;  // K rows of a block at most: 8 steps
constexpr int STEPS = CHUNK_MAX / STEP, QUADS = CHUNK_MAX / 4;
// A quad (4 K rows of the tile, 4 x 32 bytes) takes 160 bytes of shared
// memory: the 32-byte pad puts the 4 quads a warp reads at once on 4
// disjoint sets of 8 banks.
constexpr int QUAD_BYTES = 160;
// x row stride in elements (tensor cores): 264 words for bf16, 528 for f32,
// so that the B operands a warp reads fall on distinct banks
constexpr int XLD = CHUNK_MAX + 16;
}  // namespace decode

// 16 bytes from global to shared memory, bypassing L1; bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
#define DFT_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    DFT_WAIT(0) DFT_WAIT(1) DFT_WAIT(2) DFT_WAIT(3) DFT_WAIT(4) DFT_WAIT(5) DFT_WAIT(6)
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
#undef DFT_WAIT
  }
}

// The float bits of the int8 lane j of u ^ 0x80808080: (b ^ 0x80) in the
// low mantissa byte of 2^23 is 2^23 + 128 + b, so subtracting 8388736
// gives b exactly.
__device__ __forceinline__ float widen(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// Column j of a 4 x 4 byte block given as 4 row words: its 4 bytes, row 0
// lowest.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410), col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410), col[3] = __byte_perm(t1, t3, 0x7632);
}

// Two bf16, the lower in the low half: the top halves of two floats that
// bf16 holds exactly.
__device__ __forceinline__ uint32_t top_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// MR values at p (16-byte aligned when MR is a multiple of 4).
template <int MR, typename T>
__device__ __forceinline__ void load_rows(const T* p, T (&v)[MR]) {
  static_assert(sizeof(T) == 4, "staged x is 32-bit");
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MR; i += 4) {
      const int4 q = *reinterpret_cast<const int4*>(p + i);
      v[i] = *reinterpret_cast<const T*>(&q.x);
      v[i + 1] = *reinterpret_cast<const T*>(&q.y);
      v[i + 2] = *reinterpret_cast<const T*>(&q.z);
      v[i + 3] = *reinterpret_cast<const T*>(&q.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < MR; ++i) v[i] = p[i];
  }
}

// The three bf16 whose sum is f exactly (for finite f): each rounds what
// the ones before left, and three bf16 hold f32's 24 significant bits.
__device__ __forceinline__ void split3(float f, __nv_bfloat16 (&b)[3]) {
  b[0] = __float2bfloat16_rn(f);
  const float r1 = isfinite(f) ? f - __bfloat162float(b[0]) : 0.f;
  b[1] = __float2bfloat16_rn(r1);
  b[2] = __float2bfloat16_rn(r1 - __bfloat162float(b[1]));
}

// out[m, n] for m < M <= 8 over one (32-column tile, K chunk) block, the K
// splits of a tile being one cluster; see the head of this file.  ACC is
// float (x f32 or bf16) or int (int8 x, MR rows staged).
//
// Float x takes the tensor cores: out^T = w^T x^T as mma.sync m16n8k16,
// the tile's columns as its 16 rows, x's 8 rows as its 8 columns and the K
// rows 4 t .. 4 t + 3 of a quad as its k pairs (2 t, 2 t + 1) and
// (2 t + 8, 2 t + 9).  int8 -> bf16 is exact and so are the products; the
// sums are f32.  f32 x is split as it is read into the three bf16 of
// split3, each a product of its own, so the products are exactly f32's.
// int8 x takes __dp4a on a 4 x 4 byte transpose of each quad, on the CUDA
// cores.
template <int MR, typename XT, typename ACC, class Epilogue>
__global__ void __launch_bounds__(decode::THREADS)
int8_decode_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                   int K, int chunk, int w_vec16, int x_vec16, Epilogue epi) {
  using namespace decode;
  namespace cg = cooperative_groups;
  using bf16 = __nv_bfloat16;
  constexpr bool MMA = std::is_same<ACC, float>::value;
  static_assert(!MMA || MR == 8, "the tensor cores take x's rows as 8 columns");
  constexpr int X_WORDS = MMA ? MR * XLD * (int)sizeof(XT) / 4 : QUADS * MR;
  constexpr int OUTS = (MR * BN + THREADS - 1) / THREADS;  // outputs a thread takes part in
  static_assert(WARPS * MR * BN * 4 <= QUADS * QUAD_BYTES, "the warps' sums fit the tile");
  __shared__ __align__(16) unsigned char wsm[QUADS * QUAD_BYTES];
  __shared__ __align__(16) uint32_t xsm[X_WORDS];
  // Step 5: output e of the tile is finished by block (e / 128) % splits,
  // which receives every split's block sum of it in slots[row][e % 128],
  // row = (e / 128 / splits) splits + the sender's split, and counts the
  // senders' arrivals on its barrier.
  static_assert(OUTS <= MAX_SPLITS, "one split's slot rows hold a block's outputs");
  __shared__ ACC slots[MAX_SPLITS][THREADS];
  __shared__ uint64_t arrived;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * BN, k0 = split * chunk;
  const int rows = min(chunk, K - k0), steps = chunk / STEP;
  const int sums = M * BN;  // outputs of the tile, real rows only

  // 1. Warp w streams rows [64 j + 16 w, + 16) of each step j: one 16-byte
  // copy a lane, one cp.async group a step, all in flight at once.
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int r = STEP * j + 16 * warp + lane / 2, gn = n0 + 16 * (lane % 2);
    unsigned char* dst = wsm + (r >> 2) * QUAD_BYTES + (r & 3) * 32 + 16 * (lane % 2);
    if (j < steps) {
      if (w_vec16) {
        const bool in = r < rows && gn < N;
        cp_async16_zfill(dst, in ? w + (size_t)(k0 + r) * N + gn : w, in ? 16 : 0);
      } else {  // N % 16 != 0 or a misaligned weight: byte loads
#pragma unroll
        for (int b = 0; b < 16; ++b)
          dst[b] = (r < rows && gn + b < N) ? __ldg(w + (size_t)(k0 + r) * N + gn + b)
                                            : int8_t(0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // This block's arrival barrier (step 5), made visible to the cluster
  // while the weight lands, and the epilogue's scales of the outputs it
  // finishes: e = (split + o splits) 128 + t.
  const bool finishes = split * THREADS < sums;
  if (t == 0 && finishes) {  // one arrival from each split
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&arrived)),
                 "r"(splits));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  typename Epilogue::Scales scales[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int e = (split + o * splits) * THREADS + t;
    if (e < sums && n0 + e % BN < N) scales[o] = epi.load(e / BN, n0 + e % BN);
  }

  // 2. x rows of the chunk, staged once by the block while the weight
  // lands: x's own type [8][XLD] (tensor cores), or int8 words [k / 4][MR].
  // All of a thread's loads are issued before its stores.
  constexpr int V = 16 / (int)sizeof(XT);  // elements of one 16-byte load
  constexpr int XITER = (MR * (CHUNK_MAX / V) + THREADS - 1) / THREADS;
  alignas(16) XT v[XITER][V] = {};
#pragma unroll
  for (int it = 0; it < XITER; ++it) {
    const int e = t + it * THREADS;
    // tensor cores: consecutive threads along a row; dp4a: m fastest, so
    // a warp's transposing stores fall on at most 4 words a bank
    const int m = MMA ? e / (CHUNK_MAX / V) : e % MR;
    const int kk = (MMA ? e % (CHUNK_MAX / V) : e / MR) * V;
    if (m >= M || kk >= chunk) continue;
    const XT* src = x + (size_t)m * K + k0 + kk;
    if (x_vec16 && kk + V <= rows) {
      *reinterpret_cast<int4*>(v[it]) = __ldg(reinterpret_cast<const int4*>(src));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (kk + j < rows) v[it][j] = src[j];
    }
  }
#pragma unroll
  for (int it = 0; it < XITER; ++it) {
    const int e = t + it * THREADS;
    const int m = MMA ? e / (CHUNK_MAX / V) : e % MR;
    const int kk = (MMA ? e % (CHUNK_MAX / V) : e / MR) * V;
    if (m >= MR || kk >= chunk) continue;
    if constexpr (!MMA) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        reinterpret_cast<int*>(xsm)[(kk / 4 + j) * MR + m] = reinterpret_cast<const int*>(v[it])[j];
    } else {
      *reinterpret_cast<int4*>(reinterpret_cast<XT*>(xsm) + m * XLD + kk) =
          *reinterpret_cast<const int4*>(v[it]);
    }
  }
  __syncthreads();  // x is staged; the weight is still landing

  // 3. Each warp takes its steps as they land (no block barrier): per step a
  // quad of 4 K rows for each of its 4 row groups.
  float c[2][4] = {};  // tensor cores: the two 16 x 8 products, columns 4 g + {0..3}
  int acc[MR][4] = {};  // dp4a: lane (quad lane / 8, column word lane % 8)
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (j >= steps) break;
    cp_async_wait(STEPS - 1 - j);
    __syncwarp();  // the warp's copies of step j are visible to all its lanes
    if constexpr (MMA) {
      const int q = 16 * j + 4 * warp + tq;  // K rows 4 q .. 4 q + 3 of the chunk
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = *reinterpret_cast<const uint32_t*>(wsm + q * QUAD_BYTES + 32 * i + 4 * g) ^
               0x80808080u;
      uint32_t a[2][4];
#pragma unroll
      for (int col = 0; col < 4; ++col) {  // column 4 g + col: product col / 2, row g (+ 8)
        const float f0 = widen(u[0], col), f1 = widen(u[1], col);
        const float f2 = widen(u[2], col), f3 = widen(u[3], col);
        a[col / 2][col % 2] = top_halves(f0, f1);
        a[col / 2][2 + col % 2] = top_halves(f2, f3);
      }
      // B: x row g at K rows 4 q .. 4 q + 3, as pairs (4 q, 4 q + 1), (4 q + 2, 4 q + 3)
      const XT* xr = reinterpret_cast<const XT*>(xsm) + g * XLD + 4 * q;
      if constexpr (std::is_same<XT, float>::value) {  // three exact bf16 planes
        const float4 f = *reinterpret_cast<const float4*>(xr);
        bf16 p0[3], p1[3], p2[3], p3[3];
        split3(f.x, p0), split3(f.y, p1), split3(f.z, p2), split3(f.w, p3);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const __nv_bfloat162 lo = __halves2bfloat162(p0[p], p1[p]);
          const __nv_bfloat162 hi = __halves2bfloat162(p2[p], p3[p]);
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&lo);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&hi);
          mma::mma(c[0], a[0], b0, b1);
          mma::mma(c[1], a[1], b0, b1);
        }
      } else {
        const uint2 b = *reinterpret_cast<const uint2*>(xr);
        mma::mma(c[0], a[0], b.x, b.y);
        mma::mma(c[1], a[1], b.x, b.y);
      }
    } else {
      const int q = 16 * j + 4 * warp + lane / 8, cw = lane % 8;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(wsm + q * QUAD_BYTES + 32 * i + 4 * cw);
      uint32_t col[4];  // column cc's 4 K values in one word
      transpose4(r, col);
      int xv[MR];
      load_rows<MR>(reinterpret_cast<const int*>(xsm) + q * MR, xv);
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[m][cc] = __dp4a((int)col[cc], xv[m], acc[m][cc]);
    }
  }

  // 4. The block's sums: each warp's in the freed tile, then over the warps
  // in order.
  __syncthreads();  // every warp is done with the weight tile
  ACC* red = reinterpret_cast<ACC*>(wsm);  // [warp][MR][BN]
  if constexpr (MMA) {
    // c[p][2 h + i]: x row 2 tq + i, column 4 g + 2 p + h
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          red[(warp * MR + 2 * tq + i) * BN + 4 * g + 2 * p + h] = c[p][2 * h + i];
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[m][cc] += __shfl_xor_sync(0xffffffffu, acc[m][cc], 8);
        acc[m][cc] += __shfl_xor_sync(0xffffffffu, acc[m][cc], 16);
      }
    if (lane < 8)
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) red[(warp * MR + m) * BN + 4 * lane + cc] = acc[m][cc];
  }
  __syncthreads();

  // 5. Each block sends its sum of every output to the block that finishes
  // it (distributed shared memory), then arrives once on each finishing
  // block's barrier, releasing the stores; the finishing blocks wait for
  // all splits, sum the slots in split order and apply the epilogue.  A
  // block that only sends leaves at once.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every barrier is set up
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int e = t + o * THREADS;
    if (e >= sums) break;
    ACC s = red[e];
#pragma unroll
    for (int u = 1; u < WARPS; ++u) s += red[u * MR * BN + e];
    const int b = e / THREADS;
    *cluster.map_shared_rank(&slots[b / splits * splits + split][t], b % splits) = s;
  }
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncthreads();  // the block's stores precede its arrivals
  if (t < splits && t * THREADS < sums) {  // thread r arrives at finishing block r
    uint32_t bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(bar) : "r"(smem_u32(&arrived)), "r"(t));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
  }
  if (!finishes) return;
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], 0;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(&arrived))
      : "memory");
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int b = split + o * splits, e = b * THREADS + t;
    if (e >= sums) break;
    ACC p[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) p[r] = r < splits ? slots[o * splits + r][t] : ACC(0);
    ACC s = ACC(0);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) s += p[r];  // in split order
    if (n0 + e % BN < N) epi.store(e / BN, n0 + e % BN, s, scales[o]);
  }
}


namespace prefill {
constexpr int WARPS_N = 4;
constexpr int BN = 32 * WARPS_N;  // columns of a block's tile: a 32-byte segment a warp
constexpr int KSTEP = 64;         // K rows of one stage of the ring
constexpr int STAGES = 3;
constexpr int W_BYTES = KSTEP * BN;  // a stage's weight tile, (K, N) bytes
// bytes of a staged x row: the K step plus a pad that puts the rows one
// ldmatrix phase reads (bf16, int8: 16-byte pad) or one 8-byte load phase
// reads (f32: 32-byte pad) on distinct banks
template <typename XT>
__host__ __device__ constexpr int x_row_bytes() {
  return KSTEP * (int)sizeof(XT) + (sizeof(XT) == 4 ? 32 : 16);
}
template <int BM, typename XT>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (BM * x_row_bytes<XT>() + W_BYTES);
}
}  // namespace prefill

// c += a (16 x 32, row, s8) * b (32 x 8, col, s8), exact s32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[m, n] for M > 8 (or K > 8192) over one BM x 128 tile; see the head of
// this file.  The block's WM x 4 warps each take MT 16-row tiles by 32
// columns (BM = 16 MT WM).  ACC is float
// (x f32 or bf16) or int (int8 x).  The epilogue's store8 stores 8 adjacent
// columns of a row.
template <int MT, int WM, typename XT, typename ACC, class Epilogue>
__global__ void __launch_bounds__(32 * WM * prefill::WARPS_N)
int8_prefill_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                    int K, int w_vec16, int x_vec16, Epilogue epi) {
  using namespace prefill;
  using bf16 = __nv_bfloat16;
  constexpr bool INT = std::is_same<XT, int8_t>::value;
  constexpr bool F32 = std::is_same<XT, float>::value;
  static_assert(INT == std::is_same<ACC, int>::value, "int8 x sums in int, float x in float");
  constexpr int THREADS = 32 * WM * WARPS_N, BM = 16 * MT * WM;
  constexpr int XLD = x_row_bytes<XT>();
  constexpr int X_BYTES = BM * XLD, STAGE = X_BYTES + W_BYTES;
  constexpr int V = 16 / (int)sizeof(XT);  // x elements of a 16-byte chunk
  constexpr int XCH = KSTEP / V, WCH = BN / 16;  // chunks of a staged x and weight row
  // The weight row r keeps its segment s at s ^ ((r >> SW) & 3): the 4 K rows
  // a fragment read takes at once (2 apart for bf16, 4 apart for s8) then
  // fall on 4 distinct segments, 32 distinct banks.
  constexpr int SW = INT ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = (K + KSTEP - 1) / KSTEP;

  // One stage: x rows [m0, m0 + BM) and weight rows [k0, k0 + 64) of the
  // tile's columns, 16 bytes a copy, zeros outside the operands.
  auto load_stage = [&](int buf, int step) {
    unsigned char* xs = smem + buf * STAGE;
    unsigned char* ws = xs + X_BYTES;
    const int k0 = step * KSTEP;
    for (int e = tid; e < BM * XCH; e += THREADS) {
      const int r = e / XCH, c = e % XCH, gm = m0 + r, gk = k0 + c * V;
      unsigned char* dst = xs + r * XLD + 16 * c;
      const XT* src = x + (size_t)gm * K + gk;
      if (x_vec16) {
        const bool in = gm < M && gk < K;
        cp_async16_zfill(dst, in ? src : x, in ? 16 : 0);
      } else {  // rows of K elements are not whole 16-byte chunks: plain loads
        alignas(16) XT v[V] = {};
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (gm < M && gk + j < K) v[j] = src[j];
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
      }
    }
    for (int e = tid; e < KSTEP * WCH; e += THREADS) {
      const int r = e / WCH, c = e % WCH, gk = k0 + r, gn = n0 + 16 * c;
      unsigned char* dst = ws + r * BN + 32 * ((c >> 1) ^ ((r >> SW) & 3)) + 16 * (c & 1);
      const int8_t* src = w + (size_t)gk * N + gn;
      if (w_vec16) {
        const bool in = gk < K && gn < N;
        cp_async16_zfill(dst, in ? src : w, in ? 16 : 0);
      } else {  // N % 16 != 0 or a misaligned weight: byte loads
        alignas(16) int8_t v[16] = {};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gk < K && gn + j < N) v[j] = src[j];
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
      }
    }
  };

  // The B fragments' word of weight row r: columns 4 g .. 4 g + 3 of the
  // warp's segment, the sign bit flipped for widening (float x).
  auto weight_word = [&](const unsigned char* ws, int r) {
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(ws + r * BN + 32 * (wn ^ ((r >> SW) & 3)) + 4 * g);
    return INT ? u : u ^ 0x80808080u;
  };

  ACC acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = ACC(0);
  const int row0 = wm * 16 * MT;  // the warp's first row in the tile

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait(STAGES - 2);  // this thread's copies of `step` have landed
    __syncthreads();            // everyone's have, and the buffer refilled next is free
    if (step + STAGES - 1 < steps) load_stage((step + STAGES - 1) % STAGES, step + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const unsigned char* xs = smem + (step % STAGES) * STAGE;
    const unsigned char* ws = xs + X_BYTES;
    if constexpr (INT) {
      // m16n8k32: B of n8 tile j is column 4 g + j of the segment, K rows
      // 4 tq .. 4 tq + 3 (b0) and 16 + 4 tq .. (b1)
#pragma unroll
      for (int kk = 0; kk < KSTEP / 32; ++kk) {
        uint32_t b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] = weight_word(ws, 32 * kk + 16 * h + 4 * tq + i);
          transpose4(r, b[h]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];  // int8 pairs read as b16: 16 of them are 32 K bytes
          mma::load_a(a, reinterpret_cast<const bf16*>(xs), XLD / 2, row0 + 16 * mt, 16 * kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[0][j], b[1][j]);
        }
      }
    } else {
      // m16n8k16: B of n8 tile j is column 4 g + j of the segment, K rows
      // (2 tq, 2 tq + 1) (b0) and (2 tq + 8, 2 tq + 9) (b1), widened to bf16
#pragma unroll
      for (int kk = 0; kk < KSTEP / 16; ++kk) {
        uint32_t b[4][2];
        {
          const int k = 16 * kk + 2 * tq;
          const uint32_t r[4] = {weight_word(ws, k), weight_word(ws, k + 1),
                                 weight_word(ws, k + 8), weight_word(ws, k + 9)};
          uint32_t col[4];
          transpose4(r, col);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j][0] = top_halves(widen(col[j], 0), widen(col[j], 1));
            b[j][1] = top_halves(widen(col[j], 2), widen(col[j], 3));
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (F32) {
            // A: rows g, g + 8 at K 2 tq, 2 tq + 1 and 2 tq + 8, 2 tq + 9,
            // each pair split into three exact bf16 parts
            const float* xr = reinterpret_cast<const float*>(xs + (row0 + 16 * mt + g) * XLD) +
                              16 * kk + 2 * tq;
            constexpr int R8 = 8 * XLD / 4;  // floats of 8 rows
            const float2 f[4] = {*reinterpret_cast<const float2*>(xr),
                                 *reinterpret_cast<const float2*>(xr + R8),
                                 *reinterpret_cast<const float2*>(xr + 8),
                                 *reinterpret_cast<const float2*>(xr + R8 + 8)};
            uint32_t a[3][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              bf16 lo[3], hi[3];
              split3(f[i].x, lo), split3(f[i].y, hi);
#pragma unroll
              for (int p = 0; p < 3; ++p) {
                const __nv_bfloat162 v = __halves2bfloat162(lo[p], hi[p]);
                a[p][i] = *reinterpret_cast<const uint32_t*>(&v);
              }
            }
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int j = 0; j < 4; ++j) mma::mma(acc[mt][j], a[p], b[j][0], b[j][1]);
          } else {
            uint32_t a[4];
            mma::load_a(a, reinterpret_cast<const bf16*>(xs), XLD / 2, row0 + 16 * mt, 16 * kk);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma::mma(acc[mt][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
  }

  // acc[mt][j][2 h + i]: row g + 8 h, column 4 (2 tq + i) + j of the
  // segment, so a thread holds columns 8 tq .. 8 tq + 7 of its rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row0 + 16 * mt + g + 8 * h;
      if (m >= M) continue;
      ACC v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[mt][j][2 * h], v[4 + j] = acc[mt][j][2 * h + 1];
      epi.store8(m, n0 + 32 * wn + 8 * tq, v);
    }
}

// The wrapper's plan (ops/quant.py): at decode shapes the K rows a block
// takes and the number of K splits, tile_m 0; at every other shape the
// prefill tile's rows, 128, 64 or 32, chunk and splits 0.
struct Plan {
  int chunk, splits, tile_m;
};

template <int MR, typename XT, typename ACC, class Epilogue>
cudaError_t launch_decode(const XT* x, const int8_t* w, int M, int N, int K,
                          const Plan& p, Epilogue epi, cudaStream_t stream) {
  using namespace decode;
  auto kernel = int8_decode_kernel<MR, XT, ACC, Epilogue>;
  if (p.splits > 8) {  // a cluster past the portable 8 blocks, on the current card
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, p.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int wv = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int xv = ((size_t)K * sizeof(XT) % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return cudaLaunchKernelEx(&cfg, kernel, x, w, M, N, K, p.chunk, wv, xv, epi);
}

template <int MT, int WM, typename XT, typename ACC, class Epilogue>
cudaError_t launch_prefill(const XT* x, const int8_t* w, int M, int N, int K, Epilogue epi,
                           cudaStream_t stream) {
  using namespace prefill;
  constexpr int BM = 16 * MT * WM, THREADS = 32 * WM * WARPS_N, SMEM = smem_bytes<BM, XT>();
  auto kernel = int8_prefill_kernel<MT, WM, XT, ACC, Epilogue>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const int wv = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int xv = ((size_t)K * sizeof(XT) % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, stream>>>(x, w, M, N, K, wv, xv, epi);
  return cudaGetLastError();
}

// Decode shapes (M <= 8, K <= 8192) take the split-K stream, every other
// the prefill tile; a plan that does not fit the shape is refused.
template <typename XT, typename ACC, class Epilogue>
cudaError_t launch_int8_product(const void* x, const void* w, int M, int N, int K,
                                const Plan& plan, Epilogue epi, cudaStream_t stream) {
  using namespace decode;
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (M > MAX_M || K > CHUNK_MAX * MAX_SPLITS) {
    if (plan.splits != 0 || plan.chunk != 0) return cudaErrorInvalidValue;
    switch (plan.tile_m) {  // 8 warps of 64 x 32, 4 of 64 x 32, 4 of 32 x 32
      case 128: return launch_prefill<4, 2, XT, ACC>(xp, wp, M, N, K, epi, stream);
      case 64: return launch_prefill<4, 1, XT, ACC>(xp, wp, M, N, K, epi, stream);
      case 32: return launch_prefill<2, 1, XT, ACC>(xp, wp, M, N, K, epi, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (plan.tile_m != 0 || plan.splits < 1 || plan.splits > MAX_SPLITS || plan.chunk < STEP ||
      plan.chunk > CHUNK_MAX || plan.chunk % STEP ||
      plan.splits != (K + plan.chunk - 1) / plan.chunk)
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<ACC, float>::value) {  // tensor cores: 8 rows always
    return launch_decode<8, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
  } else {
    if (M == 1) return launch_decode<1, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
    if (M == 2) return launch_decode<2, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
    if (M <= 4) return launch_decode<4, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
    return launch_decode<8, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
  }
}

}  // namespace dft
