// Shared tiling of the two int8 matrix products, int8_matmul.cu and
// w8a8_matmul.cu: out[M, N] = epilogue(sum_k x[m, k] * w[k, n]) with an
// int8 (K, N) row-major weight.  It replaces the K loops of the TPU kernels
// _int8_matmul_kernel and _w8a8_kernel (deepflows_tpu/ops/pallas_kernels.py).
// The int8 weight bytes are all that crosses device memory: it is widened
// only on chip.  Four designs, chosen by the wrapper's plan
// (ops/quant.py _route, and at prefill M each wrapper's own rule,
// _prefill_route for int8_matmul, _w8a8_prefill_route for w8a8_matmul):
// decode, stream, and for prefill the wgmma tile (int8_matmul with bf16 x,
// w8a8_matmul with s8 x, wherever TMA reads both operands) or the mma.sync
// tile (everything else).
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
// Stream (9 to 48 rows at any K, and at most 8 rows with K above 8192;
// int8_stream_kernel): the shapes between decode and prefill, such as
// Mistral's down projection (K 14336) at decode and a speculative verify's
// 40 rows.  Still bound by the weight bytes (2 M K N operations on K N
// bytes is 2 M operations a byte, far below the tensor cores' 295), so the
// plan (_stream_plan) again launches at least 264 blocks of (column tile,
// K chunk), a tile's splits one cluster, all resident at once (four
// blocks an SM).  The tile is 128 columns, as the prefill tile's: every K
// row of it is a whole 128-byte line, and x, which each block reads from
// L2 for its own tile, costs M / 64 of the weight's bytes for bf16 x (the
// decode kernel's 32 columns cost M / 16 and lost to the prefill tile at N
// 28672 and 32000 from M 24 in a sweep on the H100).  K goes in 32-row steps
// through a ring of 2-8 slots that the block refills as it consumes it,
// so the chunk has no limit; a slot holds a step's weight and x.  x's
// rows are NT n8 tiles that share each step's widened weight fragment, on
// mma.sync for every x type: m16n8k16 bf16 for float x, m16n8k32 s8 -> s32
// for int8 x.  The splits' sums meet by distributed shared memory, read by
// the finishing block in split order after a cluster barrier.  At 64 rows
// the stream lost to the prefill tile at one of Mistral's matrices, which
// set its 48 (PERF.md section 6).
//
// Prefill of int8_matmul with bf16 x (M > 48, K a multiple of 8, N of 16,
// both bases 16-byte aligned; int8_prefill_wgmma, the "wgmma" route): bound
// by operations (2 M K N = 3.2-12.9 GFLOP on 1-4 MB of weight at the
// decoder's M 1536, 19-235 GFLOP at Mistral's widths), which only wgmma
// brings near the card's 989 TFLOP/s.  wgmma reads B only from shared
// memory and a 16-bit B must be K-major or MN-major there, while the
// widened weight exists only in registers; so the product is out^T =
// w^T x^T: the weight is the register A operand (a 4-row read of its
// stage, one byte perm and two LOP3 and one bf16 FMA a pair: 0x4300 |
// (b & 127) is 128 + (b & 127), minus 128 or 256 by the sign, exact) and
// x's (BM, 64) slice, as TMA writes it (K-major, 128-byte swizzle), is B.
// A block owns BM rows of x by 128 NH weight columns, the plan's tile
// (128 x 256, 128 x 128 or 64 x 128: ops/quant.py _prefill_wgmma_plan,
// from block times fitted to a sweep on the H100): a producer warp keeps
// TMA loads of x's box and one or two (64 K rows, 128 bytes) weight boxes
// (NH) in a ring of mbarriers (128-192 KB), and two consumer warpgroups
// own 64 NH weight columns each, NH wgmma m64nBMk16 a 16-deep K step.  A step's A fragments
// are widened while the two steps before it are on the tensor cores, into
// spare registers, and copied in once the products that read the old ones
// are done.  The 4-row reads hit distinct banks under TMA's swizzle.  The
// accumulator rows are weight columns, so each thread stores 2 or 4
// adjacent outputs of a row at once, after the column scale.  The blocks
// go through the tiles in groups of row tiles whose x fits 24 MB, row tile
// fastest, so the weight streams from device memory about once.  It
// reaches 220-672 TFLOP/s at the decoder's and Mistral's shapes on the
// H100 (PERF.md row 5p); what holds it there: the tiles' waves over the
// 132 SMs and a block's fixed cost of about 5.6 us at the decoder's K
// 1024, and, past those, about 60% of the tensor cores' rate a block.  One
// block sums each output over all of K in a fixed order: two calls give
// the same bits.
//
// Prefill of w8a8_matmul (M > 48, K and N multiples of 16, both bases
// 16-byte aligned; the same int8_prefill_wgmma with s8 x, the "wgmma" route
// of _w8a8_prefill_route): bound by operations, 2 M K N over the card's
// 1,979 int8 TOPS, twice the bf16 rate (0.23 ms a prefill's 49 products at
// the decoder's shapes).  The same swap serves it, with no widening: 8-bit
// wgmma (m64nBMk32, s32 sums, exact) takes both operands K-major only,
// which xq's (BM, 128) slice is as TMA writes it, and which the weight
// becomes as the register A operand (the register form of 8-bit wgmma,
// CUTLASS's SM90_64xNx32_S32S8S8_RS_TN, which ptxas takes for sm_90a, so no
// transposed copy of the weight is staged for the shared-memory form): a
// thread reads one word (4 columns) from each of 4 K rows of the staged
// (128 K rows, 128 bytes) weight box and a 4 x 4 byte transpose gives each
// column's 4 K-consecutive bytes.  At the 128-column tiles the rows a
// warp's lanes read at once are staggered (lane q's load i takes row 4 q +
// ((i + q) & 3), the transpose's selectors rotated to match), so they fall
// on distinct chunks of the swizzle: no bank conflict; at 256 columns the
// plain order, with its 2-way conflict, timed faster (wgp::Fragments).  x's
// box rows are 128 bytes at BK 128, as bf16's at 64, so the ring, the
// descriptor (a k32 step adds 32 bytes), the producer, the launch order (a
// group holds twice the rows) and the epilogue's shape are shared; the
// epilogue computes float(acc) * sx[m] * sw[n] in that order, so the result
// is the plain twin's bit for bit.  Its times beside the bound are in
// PERF.md row 7p.
//
// Prefill and every other call (M > 48; int8_prefill_kernel, the "mma"
// route of both wrappers: f32 x, ragged widths, a misaligned operand):
// bound by operations, not bytes.  At the decoder's
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

#include "hopper.cuh"
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

// v[0 .. C - 1] to dst in one store (the wgmma tile's epilogue: C 2 or 4,
// dst C-element aligned)
template <typename OT, int C>
__device__ __forceinline__ void store_vec(OT* dst, const float (&v)[C]) {
  if constexpr (std::is_same<OT, float>::value) {
    if constexpr (C == 2) *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    else *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 b[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (C == 2) *reinterpret_cast<__nv_bfloat162*>(dst) = b[0];
    else *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(b);
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

// ------------------------------------------------------------------
// The prefill on Hopper's tensor cores (the "wgmma" route of int8_matmul
// with bf16 x and of w8a8_matmul with s8 x): out^T = w^T x^T, so that the
// int8 weight is wgmma's register A operand (widened to bf16 for bf16 x,
// as it is for s8 x) and x's (BM, BK) slice, as TMA lays it in shared
// memory (K-major, 128-byte swizzle; BK is 64 bf16 or 128 s8, one 128-byte
// row of the box either way), is B.  A block owns BM rows of x by 128 NH
// weight columns: warpgroup 0 is the producer, whose one thread keeps TMA
// loads of x's box and NH weight boxes (BK K rows, 128 bytes each) in a
// ring of full and empty mbarriers; warpgroups 1 and 2 are consumers of
// 64 NH weight columns each, NH wgmma m64nBMk16 (bf16, f32 sums) or
// m64nBMk32 (s8, exact s32 sums) a K step of 32 bytes of x.  The two x
// types share the ring, the producer, the launch order and the epilogue's
// shape; only the fragment read, the wgmma and the accumulator type
// differ.  See the head of this file.
namespace wgp {

using namespace dft::hopper;
// K rows a stage: one 128-byte row of x's box, 64 bf16 or 128 s8
template <typename XT>
__host__ __device__ constexpr int bk() { return 128 / (int)sizeof(XT); }
// K rows a wgmma: 32 bytes of x, 16 bf16 or 32 s8
template <typename XT>
__host__ __device__ constexpr int kstep() { return 32 / (int)sizeof(XT); }
constexpr int THREADS = 384;  // the producer warpgroup and two consumers
// 128 x 40 + 256 x 232 registers = 64,512, what 384 threads of 168 hold at launch
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// one weight box, (K, N) bytes: BK K rows of 128 columns
template <typename XT>
__host__ __device__ constexpr int w_box() { return bk<XT>() * 128; }
// the ring: as many stages as RING_BYTES holds, at most MAX_STAGES
constexpr int RING_BYTES = 196608, MAX_STAGES = 8;
// the rows of x a group of the launch order reads, at most (of the H100's 50 MB L2)
constexpr long long GROUP_BYTES = 25165824;  // 24 MiB
template <typename XT>
__host__ __device__ constexpr int stage_bytes(int bm, int nh) {
  return bm * 128 + nh * w_box<XT>();
}
template <typename XT>
__host__ __device__ constexpr int stages(int bm, int nh) {
  return RING_BYTES / stage_bytes<XT>(bm, nh) < MAX_STAGES ? RING_BYTES / stage_bytes<XT>(bm, nh)
                                                           : MAX_STAGES;
}
template <typename XT>
__host__ __device__ constexpr int smem_bytes(int bm, int nh) {  // 1024-byte alignment, ring, barriers
  return 1024 + stages<XT>(bm, nh) * stage_bytes<XT>(bm, nh) + 2 * stages<XT>(bm, nh) * 8;
}

struct Maps {  // x (K, M) in boxes of BK x BM, the weight (N, K) in boxes of 128 x BK
  CUtensorMap x, w;
};

template <class Epilogue>
struct Args {
  Maps maps;  // first: a CUtensorMap is 64-byte aligned in the parameter space
  Epilogue epi;
  int M, N, K, group;  // group: row tiles a group of the launch order (see the kernel)
};

// (a & b) | c in one LOP3 (the compiler splits it where b and c are both
// constants)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two int8 values, bytes 0 and 2 of p, as two bf16 (byte 0 in the low
// half), exactly: 0x4300 | (b & 127) is 128 + (b & 127), and the sign bit
// picks 128 or 256 to subtract, -(128 + 128 s) being 0xC300 | (b & 128).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t p) {
  const uint32_t v = and_or(p, 0x007F007Fu, 0x43004300u);
  const uint32_t c = and_or(p, 0x00800080u, 0xC300C300u);
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(c));
  return d;
}

// Byte j of u and byte j of v at bytes 0 and 2 (bytes 1 and 3 are
// bf16_pair's to ignore).
template <int J>
__device__ __forceinline__ uint32_t bytes_j(uint32_t u, uint32_t v) {
  return __byte_perm(u, v, J | J << 4 | (4 + J) << 8 | (4 + J) << 12);
}

// One thread's A fragments of a 16-deep K step, NH of them: a[h][0..3]
// hold the thread's rows g and g + 8 of product h at K rows 2 q, 2 q + 1
// (a0, a1) and 2 q + 8, 2 q + 9 (a2, a3) of the step, widened to bf16.
// `ws` is the step's first row in the consumer's weight box; o[0] and o[1]
// are the offsets of the thread's bytes in rows 2 q and 2 q + 1, swizzled
// as TMA wrote them (rows 2 q + 8 and 2 q + 9 are 1024 bytes on, with the
// same swizzle).  NH 1: 2 bytes a row, columns col (row g) and col + 1
// (row g + 8); NH 2: 4 bytes, columns col4 .. col4 + 3, product h taking
// col4 + 2 h (row g) and col4 + 2 h + 1 (row g + 8).
template <int NH>
__device__ __forceinline__ void a_fragments(const unsigned char* ws, const int (&o)[2],
                                            uint32_t (&a)[NH][4]) {
  if constexpr (NH == 1) {
    const uint32_t r0 = *reinterpret_cast<const uint16_t*>(ws + o[0]);
    const uint32_t r1 = *reinterpret_cast<const uint16_t*>(ws + o[1]);
    const uint32_t r2 = *reinterpret_cast<const uint16_t*>(ws + o[0] + 1024);
    const uint32_t r3 = *reinterpret_cast<const uint16_t*>(ws + o[1] + 1024);
    a[0][0] = bf16_pair(bytes_j<0>(r0, r1));
    a[0][1] = bf16_pair(bytes_j<1>(r0, r1));
    a[0][2] = bf16_pair(bytes_j<0>(r2, r3));
    a[0][3] = bf16_pair(bytes_j<1>(r2, r3));
  } else {
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(ws + o[0]);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(ws + o[1]);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(ws + o[0] + 1024);
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(ws + o[1] + 1024);
    a[0][0] = bf16_pair(bytes_j<0>(r0, r1));
    a[0][1] = bf16_pair(bytes_j<1>(r0, r1));
    a[0][2] = bf16_pair(bytes_j<0>(r2, r3));
    a[0][3] = bf16_pair(bytes_j<1>(r2, r3));
    a[1][0] = bf16_pair(bytes_j<2>(r0, r1));
    a[1][1] = bf16_pair(bytes_j<3>(r0, r1));
    a[1][2] = bf16_pair(bytes_j<2>(r2, r3));
    a[1][3] = bf16_pair(bytes_j<3>(r2, r3));
  }
}

// The offset of byte `col` of row r of a 128-byte-swizzled box: its
// 16-byte chunk XOR-ed with r % 8.
__device__ __forceinline__ int swizzled(int r, int col) {
  return r * 128 + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15));
}

// The selector of transpose4_rotated's column c' (0 or 1 of a pair) for
// lane q: byte j of the column is row (j - q) & 3 of the block, which is
// byte 2 c' + row of the first word (rows 0, 1) or of the second (rows 2,
// 3, index 4 on).  At q 0 these are transpose4's 0x5410 and 0x7632.
__device__ __forceinline__ uint32_t rotated_sel(int q, int c) {
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = (j - q) & 3;
    s |= (uint32_t)((i < 2 ? 0 : 4) + 2 * c + (i & 1)) << (4 * j);
  }
  return s;
}

// transpose4 of a 4 x 4 byte block whose rows came in a rotated order,
// r[i] being row (i + q) & 3: sel (rotated_sel(q, 0 and 1)) puts each
// column's bytes back in row order, so col[j] is column j's 4 bytes, row 0
// lowest, as transpose4 gives them, in as many byte perms.
__device__ __forceinline__ void transpose4_rotated(const uint32_t (&r)[4],
                                                   const uint32_t (&sel)[2],
                                                   uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t2, sel[0]), col[1] = __byte_perm(t0, t2, sel[1]);
  col[2] = __byte_perm(t1, t3, sel[0]), col[3] = __byte_perm(t1, t3, sel[1]);
}

// A consumer thread's A fragments of one K step: where its bytes lie in
// the consumer's weight box and how they become registers.  `col` is the
// thread's first column in the box (NH 1: columns col and col + 1, the
// rows g and g + 8 of the product; NH 2: col .. col + 3, product h taking
// col + 2 h (row g) and col + 2 h + 1 (row g + 8)).
template <typename XT, int NH>
struct Fragments;

// bf16 x: a_fragments, rows 2 q and 2 q + 1 (and 8 on) of a 16-deep step.
// A warp's 4 q lanes read 4 rows whose chunks differ under the swizzle:
// NH 1, one chunk of 4 banks a row (2 bytes a lane); NH 2, two chunks a row
// (4 bytes a lane), all 32 banks; no conflict.
template <int NH>
struct Fragments<__nv_bfloat16, NH> {
  int o[2];
  __device__ __forceinline__ Fragments(int col, int q)
      : o{2 * q * 128 + ((((col >> 4) ^ (2 * q)) << 4) | (col & 15)),
          (2 * q + 1) * 128 + ((((col >> 4) ^ (2 * q + 1)) << 4) | (col & 15))} {}
  __device__ __forceinline__ void read(const unsigned char* ws, uint32_t (&a)[NH][4]) const {
    a_fragments<NH>(ws, o, a);
  }
};

// s8 x: the register A operand of m64nNk32 as it is.  A thread's a0 .. a3
// are 4 K-consecutive bytes of one A row (a weight column) at K 4 q ..
// 4 q + 3 (a0 row g, a1 row g + 8) and 16 + 4 q .. (a2, a3): a read of one
// word (4 columns; NH 1: a half word, 2 columns) from each of K rows 4 q ..
// 4 q + 3 and a 4 x 4 byte transpose give them, with no widening.  In the
// plain order (lane q's load i reads row 4 q + i) the 4 q lanes of one
// load read rows i, 4 + i, 8 + i and 12 + i, and rows i and 8 + i share a
// swizzle phase: a 2-way bank conflict.  STAGGER makes lane q's load i read
// row 4 q + ((i + q) & 3), whose rows % 8 differ across q in their upper
// two bits, and rotates the transpose's selectors to put the rows back in
// order: NH 1, 4 distinct chunks; NH 2, 8 chunks, all 32 banks; no
// conflict.  Timed both ways on the H100 (tools/int8_prefill_check.py
// --orders, PERF.md section 6), the stagger made the NH 1 tiles 1.6-7.7%
// faster and the NH 2 tile 1.8-4.1% slower, so it staggers at NH 1 only.
// Rows 16 on are 2048 bytes further, with the same swizzle.
template <int NH>
struct Fragments<int8_t, NH> {
  static constexpr bool STAGGER = NH == 1;
  int o[4];
  uint32_t sel[2];
  __device__ __forceinline__ Fragments(int col, int q) {
    const int rot = STAGGER ? q : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = swizzled(4 * q + ((i + rot) & 3), col);
    sel[0] = rotated_sel(rot, 0), sel[1] = rotated_sel(rot, 1);
  }
  __device__ __forceinline__ void read(const unsigned char* ws, uint32_t (&a)[NH][4]) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // K rows 4 q .. 4 q + 3, then 16 + 4 q ..
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* p = ws + o[i] + 2048 * half;
        if constexpr (NH == 1) r[i] = *reinterpret_cast<const uint16_t*>(p);
        else r[i] = *reinterpret_cast<const uint32_t*>(p);
      }
      uint32_t col[4];
      transpose4_rotated(r, sel, col);
#pragma unroll
      for (int h = 0; h < NH; ++h) a[h][2 * half] = col[2 * h], a[h][2 * half + 1] = col[2 * h + 1];
    }
  }
};

template <typename XT, int BM, int NH, class Epilogue>
__device__ __forceinline__ void produce(const Args<Epilogue>& a, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int m0, int n0,
                                        int steps) {
  constexpr int ST = stages<XT>(BM, NH), XB = BM * 128, STAGE = stage_bytes<XT>(BM, NH);
  constexpr int BK = bk<XT>();
  tma_prefetch_map(&a.maps.x);
  tma_prefetch_map(&a.maps.w);
  for (int i = 0; i < steps; ++i) {
    const int s = i % ST;
    mbar_wait(empty + s, ((i / ST) & 1) ^ 1);  // the slot's first wait passes at once
    mbar_expect_tx(full + s, STAGE);
    unsigned char* dst = ring + s * STAGE;
    if constexpr (std::is_same<XT, int8_t>::value)
      tma_load_2d(dst, &a.maps.x, full + s, i * BK, m0);
    else
      tma_load_4d(dst, &a.maps.x, full + s, i * BK, m0, 0, 0);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      tma_load_2d(dst + XB + h * w_box<XT>(), &a.maps.w, full + s, n0 + 128 * h, i * BK);
  }
}

// Consumer c's 64 NH weight columns by the block's BM rows of x, over all
// of K; then the scales and the stores.  Step k + 1's fragments are read
// (and, for bf16 x, widened) into spare registers while steps k - 1 and k
// are on the tensor cores, and copied into the A registers of step k - 1
// once its products are done: a product in flight never has its A
// registers rewritten, and the fragment work is off the products' path.
// The accumulators are zeroed once and every wgmma adds to them (scale_d
// 1), so nothing else writes them while products are in flight.
template <typename XT, int BM, int NH, class Epilogue>
__device__ __forceinline__ void consume(const Args<Epilogue>& a, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int m0, int n0,
                                        int steps) {
  using Acc = typename std::conditional<std::is_same<XT, int8_t>::value, int, float>::type;
  constexpr int ST = stages<XT>(BM, NH), XB = BM * 128, STAGE = stage_bytes<XT>(BM, NH);
  constexpr int KSTEPS = bk<XT>() / kstep<XT>();  // wgmma K steps a stage: 4
  const int c = threadIdx.x / 128 - 1, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  // this thread's first column in the consumer's box (the box of 128
  // columns is the consumer's half at NH 1, its own at NH 2), and in the tile
  const int col = NH == 1 ? 64 * c + 16 * w + 2 * g : 32 * w + 4 * g;
  const int box = NH == 1 ? 0 : c;
  const Fragments<XT, NH> frag(col, q);
  Acc acc[NH][BM / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[h][i] = Acc(0);
  // x: K-major, a K step (32 bytes of x) adds 32 bytes
  const uint64_t dx = desc_b128(ring, 16, 1024);
  unsigned char* wbox = ring + XB + box * w_box<XT>();
  uint32_t f[2][NH][4];
  mbar_wait(full, 0);
  frag.read(wbox, f[0]);
  // The loop's body has no branch around a wgmma: ptxas serialises every
  // wgmma of a path that diverges around one.
  for (int i = 0; i < steps; ++i) {
    const int s = i % ST;
    const uint64_t xs = dx + ((s * STAGE) >> 4);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        fence_regs(acc[h]);
        fence_regs(f[kk & 1][h]);
      }
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_rs<BM, 0>(acc[h], f[kk & 1][h][0], f[kk & 1][h][1], f[kk & 1][h][2],
                        f[kk & 1][h][3], xs + ((kk * 32) >> 4), 1);
      wgmma_commit();
      uint32_t next[NH][4] = {};  // step kk + 1's fragments
      if (kk + 1 < KSTEPS) {
        frag.read(wbox + s * STAGE + (kk + 1) * kstep<XT>() * 128, next);
      } else if (i + 1 < steps) {
        const int sn = (i + 1) % ST;
        mbar_wait(full + sn, ((i + 1) / ST) & 1);
        frag.read(wbox + sn * STAGE, next);
      }
      wgmma_wait<1>();  // step kk - 1's products are done: their registers are free
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        fence_regs(acc[h]);
        fence_regs(f[(kk + 1) & 1][h]);
      }
      // the products of the last stage are done: release it
      if (kk == 0 && i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % ST);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[(kk + 1) & 1][h][j] = next[h][j];
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  // acc[h][4 j + e]: x row 8 j + 2 q + e by product h's row g, acc[h][4 j
  // + 2 + e] by its row g + 8.  N is a multiple of 16 and a thread's 2 or
  // 4 columns start at a multiple of their count, so they are all in or
  // all past N.  bf16 x: the column scale here, then the epilogue stores
  // the columns at once; s8 x: the epilogue takes the sums and the column
  // scales, and applies the row's scale, then the column's.
  const int n = n0 + 128 * box + col;
  if (n >= a.N) return;
  float sc[2 * NH];
#pragma unroll
  for (int i = 0; i < 2 * NH; ++i) sc[i] = a.epi.col_scale(n + i);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * q + e;
      if (m >= a.M) continue;
      if constexpr (std::is_same<Acc, float>::value) {
        float v[2 * NH];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          v[2 * h] = acc[h][4 * j + e] * sc[2 * h];
          v[2 * h + 1] = acc[h][4 * j + 2 + e] * sc[2 * h + 1];
        }
        a.epi.store_cols(m, n, v);
      } else {
        int v[2 * NH];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          v[2 * h] = acc[h][4 * j + e];
          v[2 * h + 1] = acc[h][4 * j + 2 + e];
        }
        a.epi.store_cols(m, n, v, sc);
      }
    }
}

// Block b of the ceil(M / BM) ceil(N / (128 NH)) tiles, in an order that
// keeps operands in L2: the row tiles go in groups of a.group, and within
// a group the row tile changes fastest, so that the blocks on the card at
// once share a few weight column tiles and the group's rows of x, where
// the order by columns first streamed the whole weight from device memory
// once per row tile (a weight past the 50 MB L2 at Mistral's widths).
template <typename XT, int BM, int NH, class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
    int8_prefill_wgmma(const __grid_constant__ Args<Epilogue> a) {
  constexpr int ST = stages<XT>(BM, NH), STAGE = stage_bytes<XT>(BM, NH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* empty = full + ST;
  const int tiles_m = (a.M + BM - 1) / BM, tiles_n = (a.N + 128 * NH - 1) / (128 * NH);
  const int first = blockIdx.x / (a.group * tiles_n) * a.group;  // the group's first row tile
  const int rows = min(a.group, tiles_m - first), r = blockIdx.x % (a.group * tiles_n);
  const int m0 = (first + r % rows) * BM, n0 = r / rows * 128 * NH;
  const int steps = (a.K + bk<XT>() - 1) / bk<XT>();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce<XT, BM, NH>(a, ring, full, empty, m0, n0, steps);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<XT, BM, NH>(a, ring, full, empty, m0, n0, steps);
  }
}

}  // namespace wgp

namespace stream {
constexpr int MAX_NT = 6;              // n8 tiles of x rows: at most 48 rows, quant.STREAM_M
constexpr int MAX_SPLITS = 16;         // K splits of a column tile: the blocks of one cluster
constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int BN = 32 * WARPS;         // columns of a block's tile, 32 a warp
constexpr int STEP = 32;               // K rows of a step; a chunk is whole steps
// A quad (4 K rows of the tile, 4 x 128 bytes) takes 544 bytes: the 32-byte
// pad puts the 4 quads a warp reads at once on 4 disjoint sets of 8 banks.
constexpr int QUAD_BYTES = 4 * BN + 32;
constexpr int W_SLOT = STEP / 4 * QUAD_BYTES;  // a step of the tile's weight
// Four blocks an SM: at most 128 registers a thread and 54 KB of ring a block.
constexpr int BLOCKS_PER_SM = 4;
constexpr int RING_BYTES = 54 * 1024;
// A slot of the ring: a step of weight, then x's 8 NT rows at its K rows as
// two halves [8 NT][16] (K rows 0-15 and 16-31).
template <int NT, typename XT>
__host__ __device__ constexpr int slot_bytes() {
  return W_SLOT + 2 * 8 * NT * 16 * (int)sizeof(XT);
}
// slots of the ring: as many as RING_BYTES holds, 2 to 8
template <int NT, typename XT>
__host__ __device__ constexpr int ring_slots() {
  return RING_BYTES / slot_bytes<NT, XT>() < 2   ? 2
         : RING_BYTES / slot_bytes<NT, XT>() > 8 ? 8
                                                 : RING_BYTES / slot_bytes<NT, XT>();
}
// the ring, which the block's sums [8 NT][BN] reuse after the K loop
template <int NT, typename XT>
__host__ __device__ constexpr int smem_bytes() {
  return ring_slots<NT, XT>() * slot_bytes<NT, XT>() > 8 * NT * BN * 4
             ? ring_slots<NT, XT>() * slot_bytes<NT, XT>()
             : 8 * NT * BN * 4;
}
}  // namespace stream

// out[m, n] for m < M <= 8 NT over one (128-column tile, K chunk) block,
// the K splits of a tile being one cluster: the weight stream of the calls
// between decode and prefill (9 to 48 rows, and at most 8 rows with K above
// 8192); see the head of this file.  Warp w takes columns 32 w .. 32 w + 31
// of every 32-row step; the four warps share the step's x rows.  K goes in
// steps through a ring of 2-8 slots of 16-byte cp.async copies with one
// block barrier a step, the copies of the next R - 1 steps in flight while
// a step multiplies.  out^T = w^T x^T: the widened weight fragment of a
// quad is reused by NT n8 tiles of x rows, as mma.sync m16n8k16 (float x:
// bf16 as it is, f32 as the three exact bf16 of split3) or m16n8k32 s8 ->
// s32 (int8 x, exact).  A quad's K rows 4 q .. 4 q + 3 are the k values of
// lane t = q % 4 in both, so the A fragment's columns and the B fragment's
// rows meet.  x rows at and past M are not loaded: a column of the product
// depends on its own x row only, and those columns are never stored.  Each
// block leaves its sums in its shared memory; after a cluster barrier the
// block that finishes an output reads every split's sum of it through
// distributed shared memory and adds them in split order.
template <int NT, typename XT, typename ACC, class Epilogue>
__global__ void __launch_bounds__(stream::THREADS, stream::BLOCKS_PER_SM)
int8_stream_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                   int K, int chunk, int w_vec16, int x_vec16, Epilogue epi) {
  using namespace stream;
  namespace cg = cooperative_groups;
  using bf16 = __nv_bfloat16;
  constexpr bool INT = std::is_same<XT, int8_t>::value;
  static_assert(INT == std::is_same<ACC, int>::value, "int8 x sums in int, float x in float");
  constexpr int MR = 8 * NT;
  constexpr int V = 16 / (int)sizeof(XT);           // x elements of a 16-byte copy
  constexpr int PIECES = 16 / V;                    // 16-byte copies of a half row of x
  constexpr int XHALF = MR * 16 * (int)sizeof(XT);  // bytes of one half of a slot's x
  constexpr int SLOT = slot_bytes<NT, XT>(), R = ring_slots<NT, XT>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * BN, k0 = split * chunk;
  const int rows = min(chunk, K - k0), steps = (rows + STEP - 1) / STEP;

  // The copies of step j into slot b: the weight's 32 rows of 128 bytes
  // (8 threads a row), then x's rows below M (K rows of the step as 2 PIECES
  // copies a row, consecutive threads along a row).
  auto issue = [&](int j, int b) {
    unsigned char* ws = smem + b * SLOT;
    unsigned char* xs = ws + W_SLOT;
    const int kr = STEP * j;  // the step's first K row in the chunk
#pragma unroll
    for (int it = 0; it < STEP * BN / 16 / THREADS; ++it) {
      const int e = t + it * THREADS, r = e / 8, seg = e % 8, kw = kr + r, gn = n0 + 16 * seg;
      unsigned char* dst = ws + (r >> 2) * QUAD_BYTES + (r & 3) * BN + 16 * seg;
      const int8_t* src = w + (size_t)(k0 + kw) * N + gn;
      if (w_vec16) {
        const bool in = kw < rows && gn < N;
        cp_async16_zfill(dst, in ? src : w, in ? 16 : 0);
      } else {  // N % 16 != 0 or a misaligned weight: byte loads
        alignas(16) int8_t v[16] = {};
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (kw < rows && gn + c < N) v[c] = __ldg(src + c);
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
      }
    }
    for (int e = t; e < M * 2 * PIECES; e += THREADS) {
      const int p = e % (2 * PIECES), m = e / (2 * PIECES), h = p / PIECES, c = p % PIECES;
      const int kk = kr + 16 * h + V * c;
      unsigned char* dst = xs + h * XHALF + (m * 16 + V * c) * (int)sizeof(XT);
      const XT* src = x + (size_t)m * K + k0 + kk;
      if (x_vec16) {  // K % V == 0, so a copy is wholly in or past the chunk
        const bool in = kk < rows;
        cp_async16_zfill(dst, in ? src : x, in ? 16 : 0);
      } else {  // rows of K elements are not whole 16-byte chunks: plain loads
        alignas(16) XT v[V] = {};
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (kk + i < rows) v[i] = src[i];
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < R - 1; ++s) {
    if (s < steps) issue(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // c[i][p]: x rows 8 i .. 8 i + 7 by the warp's 16 columns 4 g + 2 p and
  // 4 g + 2 p + 1 (g = 0..7), the product's rows g and g + 8.
  ACC c[NT][2][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][p][e] = ACC(0);
  const int g = lane / 4, tq = lane % 4;
  const int wcol = 32 * warp + 4 * g;  // the first of the lane's 4 columns in the tile
  for (int j = 0; j < steps; ++j) {
    cp_async_wait(R - 2);  // this thread's copies of step j have landed
    __syncthreads();       // everyone's have, and the slot refilled next is free
    if (j + R - 1 < steps) issue(j + R - 1, (j + R - 1) % R);
    asm volatile("cp.async.commit_group;\n" ::);
    const unsigned char* ws = smem + (j % R) * SLOT;
    const unsigned char* xs = ws + W_SLOT;
    if constexpr (INT) {
      // m16n8k32: A's k 4 tq .. 4 tq + 3 and 16 + 4 tq .. are quads tq and
      // 4 + tq, B's the same K rows of x row 8 i + g
      uint32_t col[2][4];  // column wcol + cc's 4 K values of quad 4 h + tq
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(ws + (4 * h + tq) * QUAD_BYTES + BN * i +
                                                    wcol);
        transpose4(r, col[h]);
      }
      uint32_t a[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        a[p][0] = col[0][2 * p], a[p][1] = col[0][2 * p + 1];
        a[p][2] = col[1][2 * p], a[p][3] = col[1][2 * p + 1];
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const unsigned char* xr = xs + (8 * i + g) * 16 + 4 * tq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + XHALF);
        mma_s8(c[i][0], a[0], b0, b1);
        mma_s8(c[i][1], a[1], b0, b1);
      }
    } else {
      // m16n8k16 a half: quad q = 4 h + tq gives the k pairs (2 tq, 2 tq + 1)
      // and (2 tq + 8, 2 tq + 9), as in the decode kernel
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 4 * h + tq;
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          u[i] = *reinterpret_cast<const uint32_t*>(ws + q * QUAD_BYTES + BN * i + wcol) ^
                 0x80808080u;
        uint32_t a[2][4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {  // column wcol + cc: product cc / 2, row g (+ 8)
          const float f0 = widen(u[0], cc), f1 = widen(u[1], cc);
          const float f2 = widen(u[2], cc), f3 = widen(u[3], cc);
          a[cc / 2][cc % 2] = top_halves(f0, f1);
          a[cc / 2][2 + cc % 2] = top_halves(f2, f3);
        }
        const XT* xh = reinterpret_cast<const XT*>(xs + h * XHALF);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const XT* xr = xh + (8 * i + g) * 16 + 4 * tq;  // x row 8 i + g, K rows 4 q ..
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
              mma::mma(c[i][0], a[0], b0, b1);
              mma::mma(c[i][1], a[1], b0, b1);
            }
          } else {
            const uint2 bb = *reinterpret_cast<const uint2*>(xr);
            mma::mma(c[i][0], a[0], bb.x, bb.y);
            mma::mma(c[i][1], a[1], bb.x, bb.y);
          }
        }
      }
    }
  }

  // The block's sums in the freed ring, [MR][BN]: c[i][p][2 h + ii] is x
  // row 8 i + 2 tq + ii, column wcol + 2 p + h.
  __syncthreads();  // every warp is done with the ring
  ACC* red = reinterpret_cast<ACC*>(smem);
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          red[(8 * i + 2 * tq + ii) * BN + wcol + 2 * p + h] = c[i][p][2 * h + ii];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sums are in its shared memory, visible to the cluster

  // Output e = m BN + column of the tile (real rows only) is finished by
  // block (e / 128) % splits, which adds the splits' sums in split order.
  const int sums = M * BN;
  for (int b = split; b * THREADS < sums; b += splits) {
    const int e = b * THREADS + t, n = n0 + e % BN;
    if (e >= sums || n >= N) continue;
    ACC p[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      p[r] = r < splits ? *cluster.map_shared_rank(red + e, r) : ACC(0);
    ACC s = ACC(0);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) s += p[r];  // in split order
    epi.store(e / BN, n, s, epi.load(e / BN, n));
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// The wrapper's plan (ops/quant.py): at decode and stream shapes the K rows
// a block takes and the number of K splits, tile_m 0; at prefill shapes the
// tile's rows, 128, 64 or 32, chunk and splits 0.
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

template <int NT, typename XT, typename ACC, class Epilogue>
cudaError_t launch_stream(const XT* x, const int8_t* w, int M, int N, int K, const Plan& p,
                          Epilogue epi, cudaStream_t stream) {
  using namespace stream;
  constexpr int SMEM = smem_bytes<NT, XT>();
  auto kernel = int8_stream_kernel<NT, XT, ACC, Epilogue>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess && p.splits > 8)  // a cluster past the portable 8 blocks
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, p.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
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

template <int BM, int NH, typename XT, class Epilogue>
cudaError_t launch_prefill_wgmma_tile(const XT* x, const void* w, int M, int N, int K,
                                      Epilogue epi, cudaStream_t stream) {
  using namespace wgp;
  Args<Epilogue> a;
  a.epi = epi;
  a.M = M, a.N = N, a.K = K;
  // as many row tiles a group as GROUP_BYTES of x holds, at least one
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + 128 * NH - 1) / (128 * NH);
  const long long fit = GROUP_BYTES / ((long long)sizeof(XT) * BM * K);
  a.group = fit < 1 ? 1 : fit > tiles_m ? tiles_m : (int)fit;
  // TMA fills x's rows past M and columns past K, and the weight's rows
  // past K and columns past N, with zeros
  bool x_map;
  if constexpr (std::is_same<XT, int8_t>::value) {
    x_map = encode_u8_2d(&a.maps.x, x, K, M, K, BM);
  } else {
    const long long xd[4] = {K, M, 1, 1}, xs[3] = {2ll * K, 2ll * K * M, 2ll * K * M};
    x_map = encode_bf16_4d(&a.maps.x, x, xd, xs, BM);
  }
  if (!x_map || !encode_u8_2d(&a.maps.w, w, N, K, N, bk<XT>())) return cudaErrorInvalidValue;
  constexpr int SMEM = smem_bytes<XT>(BM, NH);
  auto kernel = int8_prefill_wgmma<XT, BM, NH, Epilogue>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles_m * tiles_n);
  kernel<<<grid, THREADS, SMEM, stream>>>(a);
  return cudaGetLastError();
}

// The wgmma prefill (the "wgmma" route, ops/quant.py _prefill_route for
// int8_matmul's bf16 x, _w8a8_prefill_route for w8a8_matmul's s8 x) over
// tiles of tile_m rows by tile_n columns, 128 x 256, 128 x 128 or 64 x 128,
// the plan's (_prefill_wgmma_plan, _w8a8_wgmma_plan; 64 x 256 was the
// fastest at no shape of the bf16 tile sweep).  TMA must be able to read
// both operands: x's rows a multiple of 16 bytes (K a multiple of 8 for
// bf16, of 16 for s8), N a multiple of 16, both bases 16-byte aligned; a
// call that is not is refused, never sent elsewhere.
template <typename XT, class Epilogue>
cudaError_t launch_prefill_wgmma(const void* x, const void* w, int M, int N, int K, int tile_m,
                                 int tile_n, Epilogue epi, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  if (M < 1 || N < 1 || K < 1 || (K * sizeof(XT)) % 16 || N % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  switch (tile_m * 1000 + tile_n) {
    case 128256: return launch_prefill_wgmma_tile<128, 2>(xp, w, M, N, K, epi, stream);
    case 128128: return launch_prefill_wgmma_tile<128, 1>(xp, w, M, N, K, epi, stream);
    case 64128: return launch_prefill_wgmma_tile<64, 1>(xp, w, M, N, K, epi, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Decode shapes (M <= 8, K <= 8192) take the decode kernel, as the plan
// must; at every other shape a plan with tile_m takes the prefill tile and
// one with K splits the stream (at most 48 rows).  A plan that does not fit
// the shape is refused.
template <typename XT, typename ACC, class Epilogue>
cudaError_t launch_int8_product(const void* x, const void* w, int M, int N, int K,
                                const Plan& plan, Epilogue epi, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (M > decode::MAX_M || K > decode::CHUNK_MAX * decode::MAX_SPLITS) {
    if (plan.tile_m != 0) {
      if (plan.splits != 0 || plan.chunk != 0) return cudaErrorInvalidValue;
      switch (plan.tile_m) {  // 8 warps of 64 x 32, 4 of 64 x 32, 4 of 32 x 32
        case 128: return launch_prefill<4, 2, XT, ACC>(xp, wp, M, N, K, epi, stream);
        case 64: return launch_prefill<4, 1, XT, ACC>(xp, wp, M, N, K, epi, stream);
        case 32: return launch_prefill<2, 1, XT, ACC>(xp, wp, M, N, K, epi, stream);
        default: return cudaErrorInvalidValue;
      }
    }
    using namespace stream;
    if (M > 8 * MAX_NT || plan.splits < 1 || plan.splits > MAX_SPLITS || plan.chunk < STEP ||
        plan.chunk % STEP || plan.splits != (K + plan.chunk - 1) / plan.chunk)
      return cudaErrorInvalidValue;
    switch ((M + 7) / 8) {  // n8 tiles of x rows
      case 1: return launch_stream<1, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
      case 2: return launch_stream<2, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
      case 3: return launch_stream<3, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
      case 4: return launch_stream<4, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
      case 5: return launch_stream<5, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
      default: return launch_stream<6, XT, ACC>(xp, wp, M, N, K, plan, epi, stream);
    }
  }
  using namespace decode;
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
