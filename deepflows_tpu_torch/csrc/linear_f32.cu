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
//   128 x 128 output tile per block of 256 threads, one block an SM (up to
//   255 registers a thread, no spill), each thread an 8 x 8 register
//   micro-tile; a warp owns 32 x 64 outputs, so a k row's loads reach 4
//   row addresses of A and 8 column addresses of B.  K streams in stages of
//   32 rows through a 4-stage ring with one barrier a stage.  Where both
//   operands' rows start 16-byte aligned (a unit stride, the other stride
//   a multiple of 4 floats, an aligned base) thread 0 fills the ring
//   by TMA (csrc/hopper.cuh; 128-byte swizzled stages, an mbarrier each,
//   zeros past M, N and K): the copies cost no thread an instruction.
//   Else every thread copies with cp.async, 16 bytes where an operand's
//   rows allow it, else 4, into stages padded to keep the reads free of
//   bank conflicts.  Each operand's stage keeps the layout its unit stride
//   gives, [rows][K] or [K][rows], and the fragment loads follow it, so a
//   transposed view costs no copy.  Tiles run in groups of 16 tile rows
//   for L2.  Each output is one fmaf chain over k = 0 .. K - 1 from 0, so
//   this tile and the small tile with one split give the same bits.  With
//   its copies and barriers cut out it keeps 2.9 of its 3.1 ms at 4096^3:
//   what bounds it is the FMA chain and its shared-memory loads (PERF.md).
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
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;  // 0: no read, the destination is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(bytes));
}

// 16 bytes, of which the first `bytes` (0, 4, 8, 12 or 16) are read and the
// rest zero-filled; gmem is 16-byte aligned
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI>
__device__ __forceinline__ float epilogue(float y, const float* __restrict__ bias, int col) {
  if (EPI >= 1) y += bias[col];
  if (EPI == 2) y = y < 0.f ? 0.f : y;
  if (EPI == 3) y = tanhf(y);
  return y;
}

// The large tile: a 128 x 16·TN output tile a block of 8 warps, K through
// a ring of stages filled by TMA or cp.async.
namespace large {

constexpr int BM = 128, THREADS = 256;
// A thread's columns (8 or 16), K rows a stage, stages in the ring, blocks
// an SM that ptxas must fit, and K rows a fragment load where K is the
// operand's unit stride (one load a row gives KG k values, all held until
// the last of them is used; 4 where it is not): the fastest of the
// choices tools/linear_ce_ab.py builds from copies of these lines
// (PERF.md).
constexpr int TN = 8;
constexpr int BK = 32, STAGES = 4;
constexpr int MIN_BLOCKS = 1;
constexpr int KG_UNIT = 4;
constexpr int BN = 16 * TN;
constexpr int GROUP = 16;  // tile rows whose blocks run together (L2)
// An operand's stage is [rows][BK + 4] when K is its unit stride (16-byte
// copies along K), else [BK][rows + 4] (rows of M or N).
constexpr int KROW = BK + 4;
template <int ROWS>
constexpr int operand_floats() {
  return ROWS * KROW > BK * (ROWS + 4) ? ROWS * KROW : BK * (ROWS + 4);
}
constexpr int A_FLOATS = operand_floats<BM>(), STAGE = A_FLOATS + operand_floats<BN>();
constexpr int SMEM = STAGES * STAGE * 4;
// Fed by TMA (both operands' rows 16-byte aligned, BK 32: a box row is 128
// bytes), a stage is unpadded and 128-byte swizzled: A then B, each
// [rows][32] when K is its unit stride, else [rows / 32][BK][32]; the
// ring's full barriers follow the stages.
constexpr int A_TMA = BM * BK, STAGE_TMA = (BM + BN) * BK;
constexpr int SMEM_TMA = 1024 + STAGES * STAGE_TMA * 4 + STAGES * 8;

struct Maps {  // A's and B's tensor maps (the TMA instances)
  CUtensorMap a, b;
};

// One stage of one operand by TMA, issued by one thread: rows r0 .. r0 +
// ROWS - 1, K rows k0 .. k0 + BK - 1; the tensor map gives zeros past the
// edges.
template <bool KU, int ROWS>
__device__ __forceinline__ void tma_stage(float* dst, const CUtensorMap* map, uint64_t* bar, int r0,
                                          int k0) {
  if (KU) {
    dft::hopper::tma_load_2d(dst, map, bar, k0, r0);
  } else {
#pragma unroll
    for (int j = 0; j < ROWS / 32; ++j)
      dft::hopper::tma_load_2d(dst + j * BK * 32, map, bar, r0 + 32 * j, k0);
  }
}

// One stage of one operand: ROWS rows from r0 (of M for A, of N for B), K
// rows k0 .. k0 + BK - 1, from x with stride sr along rows and sk along K;
// zeros past R and K.  KU: the [ROWS][KROW] layout.  vec: 16-byte copies
// (the unit stride's axis is 4-float aligned), else 4-byte copies.
template <bool KU, int ROWS>
__device__ __forceinline__ void load_stage(float* dst, const float* x, int R, int K,
                                           long long sr, long long sk, int r0, int k0,
                                           bool vec) {
  constexpr int RROW = ROWS + 4;
  // Opaque copies of the operand's base and strides: without them ptxas
  // hoists every copy's address out of the K loop into registers that the
  // outputs need.
  uintptr_t base = reinterpret_cast<uintptr_t>(x);
  asm volatile("" : "+l"(base), "+l"(sr), "+l"(sk));
  x = reinterpret_cast<const float*>(base);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CHUNKS = ROWS * BK / 4 / THREADS;  // 16-byte copies a thread
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int id = tid + THREADS * i;
      int r, k, bytes;
      if (KU) {
        r = id / (BK / 4), k = 4 * (id % (BK / 4));
        bytes = r0 + r < R ? 4 * max(0, min(4, K - k0 - k)) : 0;
      } else {
        k = id / (ROWS / 4), r = 4 * (id % (ROWS / 4));
        bytes = k0 + k < K ? 4 * max(0, min(4, R - r0 - r)) : 0;
      }
      const float* src = bytes ? x + (r0 + r) * sr + (k0 + k) * sk : x;
      cp_async16(dst + (KU ? r * KROW + k : k * RROW + r), src, bytes);
    }
  } else {
    constexpr int COPIES = ROWS * BK / THREADS;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int id = tid + THREADS * i;  // neighbouring threads along the unit stride
      const int r = KU ? id / BK : id % ROWS, k = KU ? id % BK : id / ROWS;
      const bool ok = r0 + r < R && k0 + k < K;
      cp_async4(dst + (KU ? r * KROW + k : k * RROW + r),
                ok ? x + (r0 + r) * sr + (k0 + k) * sk : x, ok);
    }
  }
}

// KG floats of a stage row as one shared load
template <int KG>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void put(float (&f)[1], const float* p) { f[0] = *p; }
};
template <>
struct Vec<2> {
  __device__ static void put(float (&f)[2], const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void put(float (&f)[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
};

// Warp w owns rows 32 (w / 2) .. + 31 and columns 8 TN (w % 2) .. + 8 TN - 1
// of the tile; lane l = 8 lm + lc holds 8 x TN outputs: with K the unit
// stride of A its rows are lm + 4 i (the four lanes' rows of one load sit
// in four bank groups), else 4 lm + i % 4 + 16 (i / 4) (16-byte loads of
// four rows a k); its columns likewise, lc + 8 j or 4 lc + j % 4 + 32 (j / 4).
template <bool AK>
__device__ __forceinline__ int tile_row(int i) {
  const int w = threadIdx.x / 32, lm = threadIdx.x % 32 / 8;
  return 32 * (w / 2) + (AK ? lm + 4 * i : 4 * lm + i % 4 + 16 * (i / 4));
}
template <bool BKU>
__device__ __forceinline__ int tile_col(int j) {
  const int w = threadIdx.x / 32, lc = threadIdx.x % 8;
  return 8 * TN * (w % 2) + (BKU ? lc + 8 * j : 4 * lc + j % 4 + 32 * (j / 4));
}

// Float (r, c) of a 128-byte-swizzled box of rows of 32 floats: the
// 16-byte chunks of row r XOR-ed with r % 8
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 32 + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// The fragments of K rows kg .. kg + KG - 1 of a stage with ROWS rows:
// f[k][i] of the thread's row (A) or column (B) i.  SW: the TMA layout.
template <bool KU, int KG, bool IS_A, int COUNT, int ROWS, bool SW>
__device__ __forceinline__ void fragments(float (&f)[KG][COUNT], const float* s, int kg) {
  if (KU) {  // one load of KG floats along K a row
#pragma unroll
    for (int i = 0; i < COUNT; ++i) {
      const int r = IS_A ? tile_row<true>(i) : tile_col<true>(i);
      float v[KG];
      Vec<KG>::put(v, s + (SW ? swizzled(r, kg) : r * KROW + kg));
#pragma unroll
      for (int k = 0; k < KG; ++k) f[k][i] = v[k];
    }
  } else {  // 16-byte loads of 4 rows a k
#pragma unroll
    for (int k = 0; k < KG; ++k)
#pragma unroll
      for (int h = 0; h < COUNT / 4; ++h) {
        const int n = IS_A ? tile_row<false>(4 * h) : tile_col<false>(4 * h);
        float v[4];
        Vec<4>::put(v, s + (SW ? (n >> 5) * BK * 32 + swizzled(kg + k, n & 31)
                               : (kg + k) * (ROWS + 4) + n));
#pragma unroll
        for (int e = 0; e < 4; ++e) f[k][4 * h + e] = v[e];
      }
  }
}

// epilogue: 0 none, 1 + bias, 2 relu(+ bias), 3 tanh(+ bias).  AK: K is A's
// unit stride; BKU: K is B's unit stride (and N is not); TMA: the stages
// come by TMA (maps), else by cp.async.  Each output is one fmaf chain over
// k = 0 .. K - 1 from 0, as the small tile's with one split: the two give
// the same bits.
template <int EPI, bool AK, bool BKU, bool TMA>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
linear_f32_kernel(const __grid_constant__ Maps maps, const float* __restrict__ A,
                  const float* __restrict__ B, const float* __restrict__ bias,
                  float* __restrict__ C, int M, int N, int K, long long sam, long long sak,
                  long long sbk, long long sbn, int avec, int bvec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];  // STAGES x (A, B)
  constexpr int KG = AK || BKU ? KG_UNIT : 4;  // K rows a fragment load
  constexpr int SA = TMA ? A_TMA : A_FLOATS, SS = TMA ? STAGE_TMA : STAGE;  // floats
  // the block's tile: groups of GROUP tile rows, down the rows of a group first
  const int nbm = (M + BM - 1) / BM, nbn = (N + BN - 1) / BN, per = GROUP * nbn;
  const int first = blockIdx.x / per * GROUP, rows = min(GROUP, nbm - first);
  const int m0 = (first + blockIdx.x % per % rows) * BM, n0 = blockIdx.x % per / rows * BN;
  float* smem = reinterpret_cast<float*>(smem_raw);
  uint64_t* full = nullptr;  // the TMA ring's barriers
  if constexpr (TMA) {  // the swizzle's period: 1024-byte aligned stages
    const uint32_t raw = dft::hopper::smem_addr(smem_raw);
    smem = reinterpret_cast<float*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
    full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_TMA);
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) dft::hopper::mbar_init(full + s, 1);
      dft::hopper::mbar_fence_init();
    }
    __syncthreads();
  }

  auto load = [&](int stage, int t) {
    float* s = smem + stage * SS;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        dft::hopper::mbar_expect_tx(full + stage, STAGE_TMA * 4);
        tma_stage<AK, BM>(s, &maps.a, full + stage, m0, t * BK);
        tma_stage<BKU, BN>(s + SA, &maps.b, full + stage, n0, t * BK);
      }
    } else {
      load_stage<AK, BM>(s, A, M, K, sam, sak, m0, t * BK, avec);
      load_stage<BKU, BN>(s + SA, B, N, K, sbn, sbk, n0, t * BK, bvec);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s, s);
    if constexpr (!TMA) cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    if constexpr (!TMA) cp_async_wait<STAGES - 2>();  // stage t has landed
    __syncthreads();              // ... for every thread; stage t - 1 is free
    if (t + STAGES - 1 < tiles) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    if constexpr (TMA)
      dft::hopper::mbar_wait(full + t % STAGES, (t / STAGES) & 1);  // stage t has landed
    else
      cp_async_commit();
    const float* as = smem + t % STAGES * SS;
    const float* bs = as + SA;
#pragma unroll
    for (int kg = 0; kg < BK; kg += KG) {
      float a[KG][8], b[KG][TN];
      fragments<AK, KG, true, 8, BM, TMA>(a, as, kg);
      fragments<BKU, KG, false, TN, BN, TMA>(b, bs, kg);
#pragma unroll
      for (int k = 0; k < KG; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[k][i], b[k][j], acc[i][j]);
    }
  }
  if constexpr (!TMA) cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row<AK>(i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tile_col<BKU>(j);
      if (col < N) C[static_cast<long long>(row) * N + col] = epilogue<EPI>(acc[i][j], bias, col);
    }
  }
}

template <int EPI, bool AK, bool BKU, bool TMA>
cudaError_t launch(const Maps& maps, const float* a, const float* b, const float* bias, float* c,
                   int M, int N, int K, long long sam, long long sak, long long sbk,
                   long long sbn, int avec, int bvec, cudaStream_t st) {
  auto kernel = linear_f32_kernel<EPI, AK, BKU, TMA>;
  const int smem = TMA ? SMEM_TMA : SMEM;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kernel<<<blocks, THREADS, smem, st>>>(maps, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec,
                                        bvec);
  return cudaGetLastError();
}

// A map of one operand, rows of `rows` (M or N) and K: along K where it is
// the unit stride, else along the rows; boxes of 32 x ROWS or 32 x BK.
inline bool encode(CUtensorMap* map, const float* x, bool ku, long long rows, long long K,
                   long long sr, long long sk, int box_rows) {
  return ku ? dft::hopper::encode_f32_2d(map, x, K, rows, 4 * sr, box_rows)
            : dft::hopper::encode_f32_2d(map, x, rows, K, 4 * sk, BK);
}

template <int EPI, bool AK, bool BKU>
cudaError_t pick(bool tma, const float* a, const float* b, const float* bias, float* c, int M,
                 int N, int K, long long sam, long long sak, long long sbk, long long sbn,
                 int avec, int bvec, cudaStream_t st) {
  Maps maps;
  if (!tma)
    return launch<EPI, AK, BKU, false>(maps, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec,
                                       bvec, st);
  if (!encode(&maps.a, a, AK, M, K, sam, sak, BM) || !encode(&maps.b, b, BKU, N, K, sbn, sbk, BN))
    return cudaErrorInvalidValue;
  return launch<EPI, AK, BKU, true>(maps, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec, bvec,
                                    st);
}

// The operands' layouts: K A's unit stride (else M, or neither), K B's unit
// stride and N not (else N, or neither); 16-byte copies where the unit
// stride's rows start 16-byte aligned, and TMA (the maps encoded on every
// call) where both operands' do.
template <int EPI>
cudaError_t run(const float* a, const float* b, const float* bias, float* c, int M, int N, int K,
                long long sam, long long sak, long long sbk, long long sbn, cudaStream_t st) {
  const bool ak = sak == 1, bku = sbn != 1 && sbk == 1;
  const bool a16 = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b16 = reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int avec = a16 && (ak ? sam % 4 == 0 : sam == 1 && sak % 4 == 0);
  const int bvec = b16 && (bku ? sbn % 4 == 0 : sbn == 1 && sbk % 4 == 0);
  const bool tma = BK == 32 && avec && bvec;
  if (ak && bku) return pick<EPI, true, true>(tma, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec, bvec, st);
  if (ak) return pick<EPI, true, false>(tma, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec, bvec, st);
  if (bku) return pick<EPI, false, true>(tma, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec, bvec, st);
  return pick<EPI, false, false>(tma, a, b, bias, c, M, N, K, sam, sak, sbk, sbn, avec, bvec, st);
}

}  // namespace large


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
    if (row < M && col < N) C[static_cast<long long>(row) * N + col] = epilogue<EPI>(y, bias, col);
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
  if (tile == large::BM) return large::run<EPI>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, st);
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
  const bool whole = tile == large::BM && splits == 1 && chunk == K;
  const bool split = tile == small::BM && splits >= 1 && splits <= small::MAX_SPLITS &&
                     chunk >= 8 && chunk % 8 == 0 && splits == (K + chunk - 1) / chunk;
  if (!whole && !split) return static_cast<int>(cudaErrorInvalidValue);
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
