// fused_linear_ce: per-row cross-entropy of the LM head x @ w + b against
// integer targets, forward and backward, with the (N, V) logits never
// written to device memory.
//
// Replaces the TPU kernels of deepflows_tpu/ops/pallas_kernels.py
// fused_linear_ce: _flce_fwd_f32 (forward), _flce_dx_kernel and
// _flce_dw_kernel (backward).  x (N, D) and w (D, V) in f32 or bf16 (one
// dtype), b (V,) in f32 or bf16, targets (N,) int32.  Forward: loss_i =
// lse_i - logit_i,t_i and lse_i, both f32, from an online max and sum-exp
// over vocab tiles.  Backward: dl = (exp(logit - lse) - onehot(t)) * g per
// recomputed logits tile; dx = dl w^T in x's dtype, dw = x^T dl in w's,
// db = sum_rows dl in b's.  As in the TPU kernels, logits = (x . w) in f32
// plus b widened to f32; vocab columns past V count as -1e30 (probability
// 0); dl is rounded to w's dtype before the dx product and to x's before
// the dw product, while db sums the f32 dl.  A target outside [0, V)
// matches no column: its row's loss is lse.
//
// What bounds it on an H100: at the training slice's shape (N 8192, D 1024,
// V 8192, bf16) the forward is 137 GFLOP of products (139 us at the bf16
// tensor-core rate) and the backward three times that as the function
// needs it (a logits recompute, dx and dw), each against 34 MB of
// operands, so both are bound by operations, and only tensor cores
// approach the bound.
//
// The bf16 forward has two kernels (the route is ops/fused_ce.py
// _fwd_route's, the vocab split _fwd_plan's; a call never falls back).
// w's rows are ldw >= V elements apart: the wrapper copies a bf16 w whose
// rows do not start 16-byte aligned (GPT-2's V 50257) into a buffer whose
// rows are padded to a multiple of 8, once a step, so that TMA and the
// 16-byte cp.async copies can read it; no kernel reads a column past V.
// Where TMA can read x and w (D and ldw multiples of 8, 16-byte aligned
// bases) it runs ce_fwd_wgmma (namespace wgf): a producer warp loads x's
// (128, 64) box and w's (64, 256) slice into a 4-stage mbarrier ring, and
// two consumer warpgroups of 64 rows run wgmma m64n128k16 from shared
// memory (w MN-major, read with the transpose-B bit), so each w slice is
// read from shared memory once per warpgroup where the mma.sync kernel's
// 8 warps each loaded it with ldmatrix.  A block owns 128 rows and a
// split's vocab tiles of 256; the online max, sum-exp and target logit
// run on the accumulators, the first 128 columns' while the last 128
// columns' final products run.  The splits bring the grid to one block an
// SM.  Every other bf16 call (D not a multiple of 8, x's base misaligned)
// runs ce_fwd_tc: mma.sync m16n8k16 fed by ldmatrix (mma_bf16.cuh),
// a block of 8 warps owning 128 rows (16 a warp) and a split's vocab
// columns; (x, w) chunks of 32 along D stream through a cp.async double
// buffer, and each row's max, sum-exp and target logit run online over
// vocab tiles of 128 as in the TPU kernel, about two blocks an SM.  On
// both, the last split of a row block to finish (an atomic count) combines
// the splits' partials in a fixed order, so two calls give the same bits.
//
// The bf16 backward has two kernels, each ONE launch of two roles in
// clusters of C = ceil(D / 256) blocks (D <= 4096) that split D, block r
// owning D columns [256 r, 256 r + 256); the route is ops/fused_ce.py
// _bwd_route's, by the forward's rule (a call never falls back).  What
// held a one-block design back was how often each operand crossed L2: a
// block that owns all of D can hold only 32 rows of dx (or 32 columns of
// dw) in registers, so every block staged all of w (or x), 8.6 GB through
// L2 for 67 MB of operands.  Split over C blocks, a dx cluster owns 128
// rows (each block a (128, 256) slice of dx in registers, its (128, 256)
// slice of x resident) and a dw cluster 128 vocab columns (each block a
// (256, 128) slice of dw, its (256, 128) slice of w resident), so w and x
// each cross L2 about 1 GB.  A dx block walks the vocabulary in steps of
// 64, computes its partial logits over its 256 columns of D and stores
// them through distributed shared memory into the slots of the blocks that
// finish them (each block finishes 64 / C of the columns; a store costs no
// round trip, where a remote load does); each block adds the C partials of
// its columns from its own slots in rank order, forms dl and stores it in
// bf16 into every block's dl tile; then each block adds dl w_slice^T from
// the same staged slice of w.  A dw block is the mirror image: slices of x
// stream, dw_slice += x_slice^T dl, and db is summed from the f32 dl, each
// block over its own columns in a fixed order.  The longer role's clusters
// start first.  Both roles recompute the logits, as the TPU kernel's two
// pallas_calls do: four products where the function needs three.  Sums run
// in a fixed order and without float atomics: two calls give the same
// bits.
// - Where TMA can read x (D a multiple of 8, a 16-byte aligned base; w is
//   staged) it runs ce_bwd_wgmma (namespace bwg): a producer warp keeps TMA
//   loads in an mbarrier ring and two consumer warpgroups of 64 rows (or
//   vocab columns) run wgmma, each a pipeline of its own whose exchange
//   goes by st.async stores counted on the receiver's mbarriers, so one
//   consumer's products run while the other exchanges.  Its plan (C, 128,
//   ST) is _bwd_wgmma_plan's.
// - Every other bf16 call (D not a multiple of 8, x's base misaligned)
//   runs ce_bwd_cluster (namespace bwd): 8 warps on mma.sync fed by
//   ldmatrix, (256, 64) slices through a 3-stage cp.async ring, each step a
//   serial chain (copies, logits, the partials' exchange, a cluster
//   barrier, the combine, a barrier, the product).  Its plan (C, BM, BV) is
//   _bwd_plan's; BM and BV fall to 64 when the partials of C blocks do not
//   fit an owner's slots or 128 would leave the grid under 132 blocks.
//
// f32 x and w run on the CUDA cores in f32 FMA: the same forward with
// 64 x 64 tiles staged as f32, and a backward of 32 x 32 tiles whose block
// owns all of D (D <= 1024, the shared memory of one SM).  PERF.md holds
// the measured times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr int FBM = 64, FBV = 64, FBD = 32;  // forward tiles: rows, vocab, D chunk
constexpr int T32 = 32, LD32 = 33;           // backward tiles are 32 x 32, stride 33

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float group_max(float v) {  // over 16 lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TB>
struct Args {  // the f32 kernels' operands; b may be bf16
  const float *x, *w;
  const TB* b;
  const int* t;
  const float *lse, *g;  // backward inputs
  float* loss;           // forward outputs: loss, and lse through `lse_out`
  float* lse_out;
  float *dx, *dw;
  TB* db;
  int N, D, V, ldw;  // ldw: w's row stride (>= V)
};

template <typename TB>
__global__ void __launch_bounds__(THREADS) ce_fwd_f32(const __grid_constant__ Args<TB> a) {
  __shared__ float xs[FBM][FBD + 1];
  __shared__ float ws[FBD][FBV];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16, n0 = blockIdx.x * FBM;
  const int N = a.N, D = a.D, V = a.V;
  int tgt[4];
  float m[4], l[4], st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + tr * 4 + i;
    tgt[i] = row < N ? a.t[row] : -1;
    m[i] = NEG_INF;
    l[i] = st[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += FBV) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += FBD) {
      __syncthreads();
      for (int e = tid; e < FBM * FBD; e += THREADS) {
        const int r = e / FBD, c = e % FBD;
        xs[r][c] = (n0 + r < N && d0 + c < D) ? to_f(a.x[(long long)(n0 + r) * D + d0 + c]) : 0.f;
      }
      for (int e = tid; e < FBD * FBV; e += THREADS) {
        const int r = e / FBV, c = e % FBV;
        ws[r][c] = (d0 + r < D && v0 + c < V) ? to_f(a.w[(long long)(d0 + r) * a.ldw + v0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < FBD; ++dd) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[tr * 4 + i][dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[dd][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tc + 16 * j;
        const float lg = col < V ? acc[i][j] + to_f(a.b[col]) : NEG_INF;
        acc[i][j] = lg;
        if (col < V && col == tgt[i]) st[i] += lg;
        mx = fmaxf(mx, lg);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rs += (v0 + tc + 16 * j < V) ? expf(acc[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + group_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = group_sum(st[i]);
    const int row = n0 + tr * 4 + i;
    if (tc == 0 && row < N) {
      const float lse = m[i] + logf(l[i]);
      a.lse_out[row] = lse;
      a.loss[row] = lse - s;
    }
  }
}

// The (32, 32) logits tile of rows [n0, n0 + 32) x vocab [v0, v0 + 32): x
// chunks of 32 are staged in xs, w comes from the (DW, 32) slab ws.  Thread
// (lr = tid / 8, lc = tid % 8) gets columns lc + 8j.  Ends synchronised.
__device__ __forceinline__ void logits_tile(const float* x, int N, int D, int n0, const float* ws,
                                            float* xs, float acc[4]) {
  const int tid = threadIdx.x, lr = tid / 8, lc = tid % 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += T32) {
    __syncthreads();
    for (int e = tid; e < T32 * T32; e += THREADS) {
      const int r = e / T32, c = e % T32;
      xs[r * LD32 + c] =
          (n0 + r < N && d0 + c < D) ? to_f(x[(long long)(n0 + r) * D + d0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < T32; ++dd) {
      const float xv = xs[lr * LD32 + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(xv, ws[(d0 + dd) * LD32 + lc + 8 * j], acc[j]);
    }
  }
  __syncthreads();
}

// ws[d][c] = w[d][v0 + c] for d < DW (zero past D and V; w's rows ldw apart)
template <int DW>
__device__ __forceinline__ void stage_w(const float* w, int D, int V, int ldw, int v0,
                                        float* ws) {
  for (int e = threadIdx.x; e < DW * T32; e += THREADS) {
    const int r = e / T32, c = e % T32;
    ws[r * LD32 + c] = (r < D && v0 + c < V) ? to_f(w[(long long)r * ldw + v0 + c]) : 0.f;
  }
}

// dl of the logits tile (row n0 + lr, columns v0 + lc + 8j); 0 outside N, V
template <typename TB>
__device__ __forceinline__ float dlogit(const Args<TB>& a, int row, int col, float acc) {
  if (row >= a.N || col >= a.V) return 0.f;
  const float p = expf(acc + to_f(a.b[col]) - a.lse[row]);
  return (p - (col == a.t[row] ? 1.f : 0.f)) * a.g[row];
}

// dx of rows [n0, n0 + 32): thread (rg = tid / 32, cg = tid % 32) owns rows
// rg * 4 + i and columns cg + 32j of the (32, D) dx.
template <typename TB, int DW>
__device__ __forceinline__ void dx_block(const Args<TB>& a, int n0, float* smem) {
  constexpr int NJ = DW / T32;
  float* ws = smem;              // [DW][33]
  float* xs = ws + DW * LD32;    // [32][33]
  float* dls = xs + T32 * LD32;  // [32][33]
  const int tid = threadIdx.x, lr = tid / 8, lc = tid % 8, rg = tid / 32, cg = tid % 32;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int v0 = 0; v0 < a.V; v0 += T32) {
    stage_w<DW>(a.w, a.D, a.V, a.ldw, v0, ws);  // the previous tile ended synchronised
    float lg[4];
    logits_tile(a.x, a.N, a.D, n0, ws, xs, lg);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dls[lr * LD32 + lc + 8 * j] = dlogit(a, n0 + lr, v0 + lc + 8 * j, lg[j]);
    __syncthreads();
#pragma unroll 4
    for (int vv = 0; vv < T32; ++vv) {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dl[i] = dls[(rg * 4 + i) * LD32 + vv];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float wv = ws[(cg + T32 * j) * LD32 + vv];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dl[i], wv, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + rg * 4 + i;
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = cg + T32 * j;
      if (col < a.D) a.dx[(long long)row * a.D + col] = acc[i][j];
    }
  }
}

// dw and db of vocab columns [v0, v0 + 32): thread (dg = tid / 8, vg = tid % 8)
// owns dw rows dg + 32i and columns vg * 4 + jj; threads 0..31 own db.
template <typename TB, int DW>
__device__ __forceinline__ void dw_block(const Args<TB>& a, int v0, float* smem) {
  constexpr int NI = DW / T32;
  float* ws = smem;              // [DW][33]
  float* xs = ws + DW * LD32;    // [32][33]
  float* dls = xs + T32 * LD32;  // [32][33], rounded to x's dtype
  float* dlf = dls + T32 * LD32; // [32][33], f32 for db
  const int tid = threadIdx.x, lr = tid / 8, lc = tid % 8, dg = tid / 8, vg = tid % 8;
  float acc[NI][4], dbacc = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  stage_w<DW>(a.w, a.D, a.V, a.ldw, v0, ws);
  for (int n0 = 0; n0 < a.N; n0 += T32) {
    float lg[4];
    logits_tile(a.x, a.N, a.D, n0, ws, xs, lg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dl = dlogit(a, n0 + lr, v0 + lc + 8 * j, lg[j]);
      dls[lr * LD32 + lc + 8 * j] = dl;
      dlf[lr * LD32 + lc + 8 * j] = dl;
    }
    __syncthreads();
    if (tid < T32)
      for (int r = 0; r < T32; ++r) dbacc += dlf[r * LD32 + tid];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (i * T32 >= a.D) break;
      // x[n0 .. n0 + 32, 32i .. 32i + 32) into xs; the dl tiles stay
      for (int e = tid; e < T32 * T32; e += THREADS) {
        const int r = e / T32, c = e % T32, d = i * T32 + c;
        xs[r * LD32 + c] =
            (n0 + r < a.N && d < a.D) ? to_f(a.x[(long long)(n0 + r) * a.D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < T32; ++r) {
        const float xv = xs[r * LD32 + dg];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(xv, dls[r * LD32 + vg * 4 + jj], acc[i][jj]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = dg + T32 * i;
    if (d >= a.D) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = v0 + vg * 4 + jj;
      if (col < a.V) a.dw[(long long)d * a.V + col] = acc[i][jj];
    }
  }
  if (tid < T32 && v0 + tid < a.V) a.db[v0 + tid] = from_f<TB>(dbacc);
}

template <typename TB, int DW>
__global__ void __launch_bounds__(THREADS) ce_bwd_f32(const __grid_constant__ Args<TB> a,
                                                          int ndx) {
  extern __shared__ float smem[];
  if ((int)blockIdx.x < ndx)
    dx_block<TB, DW>(a, blockIdx.x * T32, smem);
  else
    dw_block<TB, DW>(a, (blockIdx.x - ndx) * T32, smem);
}

// ------------------------------------------------------------------
// The last split of a row block to finish combines the splits' partials
// (max, sum-exp, target logit) of rows n0 .. n0 + rows - 1 in split order,
// so two calls give the same bits; thread `tid` of `threads` takes every
// threads-th row.
__device__ __forceinline__ void combine_splits(const float* part, int N, int splits, int n0,
                                               int rows, int tid, int threads, float* lse_out,
                                               float* loss) {
  for (int r = tid; r < rows; r += threads) {
    const int row = n0 + r;
    if (row >= N) continue;
    float mm = NEG_INF;
    for (int k = 0; k < splits; ++k) mm = fmaxf(mm, __ldcg(part + (long long)k * 3 * N + row));
    float ll = 0.f, ss = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* p = part + (long long)k * 3 * N;
      ll += __ldcg(p + N + row) * expf(__ldcg(p + row) - mm);
      ss += __ldcg(p + 2 * N + row);
    }
    const float lse = mm + logf(ll);
    lse_out[row] = lse;
    loss[row] = lse - ss;
  }
}

// bf16 x and w on the tensor cores: mma.sync m16n8k16 fed by ldmatrix
namespace tc {

using namespace dft::mma;
constexpr int TH = 256;                        // 8 warps
constexpr int FM = 128, FV = 128, FD = 32;     // forward tiles: rows, vocab, D chunk
constexpr int FXL = FD + 8, FWL = FV + 8;      // their shared row strides
constexpr int MAX_SPLITS = 16;

template <typename TB>
struct Args {
  const bf16 *x, *w;
  const TB* b;
  const int* t;
  float *loss, *lse_out;  // outputs
  float* part;           // (m, l, target logit) per vocab split and row
  int* count;            // finished splits per row block, zeroed by the caller
  int N, D, V, ldw, splits, vchunk, xvec;  // ldw: w's row stride (>= V)
};

// Forward: block (rb, sp) owns rows rb * 128 .. + 127 (16 a warp) and the
// vocab columns of split sp; it streams (x, w) chunks of 32 along D through
// a double buffer and keeps each row's max, sum-exp and target logit online.
// The last split of a row block to finish combines the splits' partials.
template <typename TB>
__global__ void __launch_bounds__(TH) ce_fwd_tc(const __grid_constant__ Args<TB> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][FM * FXL + FD * FWL]
  constexpr int STAGE = FM * FXL + FD * FWL;
  __shared__ int last;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int n0 = blockIdx.x * FM, sp = blockIdx.y;
  const int vbeg = sp * a.vchunk, vend = min(a.V, vbeg + a.vchunk);
  const int nv = (vend - vbeg + FV - 1) / FV, nd = (a.D + FD - 1) / FD, total = nv * nd;
  auto fetch = [&](int i, int into) {
    bf16* xs = buf + into * STAGE;
    const int v0 = vbeg + (i / nd) * FV, d0 = (i % nd) * FD;
    stage_tile<FM, FD, TH>(xs, FXL, a.x, a.D, n0, d0, a.N, a.D, a.xvec);
    stage_tile<FD, FV, TH>(xs + FM * FXL, FWL, a.w, a.ldw, d0, v0, a.D, vend, 1);
  };
  int tgt[2];
  float m[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.f, 0.f}, st[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + w * 16 + g + 8 * r;
    tgt[r] = row < a.N ? a.t[row] : -1;
  }
  float acc[FV / 8][4];
#pragma unroll
  for (int n = 0; n < FV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  fetch(0, 0);
  cp_async_commit();
  for (int i = 0; i < total; ++i) {
    const int cur = i & 1;
    if (i + 1 < total) fetch(i + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* xs = buf + cur * STAGE;
    const bf16* ws = xs + FM * FXL;
#pragma unroll
    for (int kk = 0; kk < FD / 16; ++kk) {
      uint32_t af[4];
      load_a(af, xs, FXL, w * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < FV / 16; ++np) {
        uint32_t bf[4];
        load_b_kn(bf, ws, FWL, kk * 16, np * 16);
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two chunks on
    if (i % nd != nd - 1) continue;
    // a vocab tile is complete: online max / sum-exp and the target logit
    const int v0 = vbeg + (i / nd) * FV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < FV / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = v0 + n * 8 + 2 * t + c;
          float& x = acc[n][2 * r + c];
          x = col < vend ? x + to_f(a.b[col]) : NEG_INF;
          if (col < vend && col == tgt[r]) st[r] += x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < FV / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          rs += (v0 + n * 8 + 2 * t + c < vend) ? expf(acc[n][2 * r + c] - m_new) : 0.f;
      lsum[r] = lsum[r] * expf(m[r] - m_new) + quad_sum(rs);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < FV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float s = quad_sum(st[r]);
    const int row = n0 + w * 16 + g + 8 * r;
    if (t == 0 && row < a.N) {
      float* p = a.part + (long long)sp * 3 * a.N;
      p[row] = m[r];
      p[a.N + row] = lsum[r];
      p[2 * a.N + row] = s;
    }
  }
  __threadfence();  // the partials are visible before the count says so
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.count + blockIdx.x, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine_splits(a.part, a.N, a.splits, n0, FM, threadIdx.x, TH, a.lse_out, a.loss);
}

constexpr int fwd_smem = 2 * (FM * FXL + FD * FWL) * 2;

}  // namespace tc

// ------------------------------------------------------------------
// The bf16 forward on Hopper: wgmma fed from a TMA ring.  Warpgroup 0 is
// the producer (one thread issues every TMA load), warpgroups 1 and 2 are
// consumers of 64 rows each, so a block owns BM = 128 rows and the vocab
// tiles of one split.  A stage holds x's (128, 64) box, K-major, and w's
// (64, 256) slice as four 64-column boxes, MN-major (V is w's unit
// stride), read by wgmma with the transpose-B bit; both 128-byte swizzled,
// zeros past N, D and V.  A consumer keeps its (64, 256) logits tile in
// two accumulators of 128 columns, each a commit group, so the online
// max, sum-exp and target logit of the first half run while the second
// half's last products are on the tensor cores.
namespace wgf {

using namespace dft::hopper;
using dft::mma::bf16;
using dft::mma::quad_max;
using dft::mma::quad_sum;

// rows a block, D a stage; vocab a tile (128 or 256: accumulators of 128
// columns) and stages in the ring (tools/linear_ce_ab.py builds the others
// from copies of this line)
constexpr int BM = 128, BD = 64;
constexpr int BV = 256, ST = 4;
constexpr int NH = BV / 128;  // accumulators a consumer
constexpr int THREADS = 384;                 // the producer warpgroup and two consumers
// 128 x 40 + 256 x 232 registers = 64,512, what 384 threads of 168 hold at launch
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_SPLITS = 16;
constexpr int X_BYTES = BM * BD * 2, W_BYTES = BD * BV * 2, STAGE = X_BYTES + W_BYTES;
constexpr int SMEM = 1024 + ST * STAGE + 2 * ST * 8;  // 1024-byte alignment, ring, barriers
constexpr float LOG2E = 1.4426950408889634f;

struct Maps {  // x (D, N) in boxes of 64 x 128, w (V, D) in boxes of 64 x 64
  CUtensorMap x, w;
};

template <typename TB>
struct Args {
  Maps maps;  // first: a CUtensorMap is 64-byte aligned in the parameter space
  const TB* b;
  const int* t;
  float *loss, *lse_out;  // outputs
  float* part;            // (m, l, target logit) per vocab split and row
  int* count;             // finished splits per row block, zeroed by the caller
  int N, D, V, splits, per;  // per: vocab tiles of BV a split
};

// 2^x in one MUFU.EX2: results below 2^-126 flush to 0, far below what a
// row's sum-exp resolves against its maximum's 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online max, sum-exp and target logit of rows g and g + 8 of the warp
// over one accumulator: 128 vocab columns from cb, this lane's columns
// cb + 8 j + 2 q + e.  The bias is added and columns past vend count as
// -1e30 (probability 0), as in the mma.sync kernel.  The accumulator is
// only read: an instruction that writes it while the other accumulator's
// products are in flight makes ptxas serialise every wgmma (C7515).
template <typename TB>
__device__ __forceinline__ void online(const float (&acc)[64], int cb, int vend,
                                       const TB* __restrict__ b, const int (&tgt)[2],
                                       float (&m)[2], float (&l)[2], float (&st)[2], int q) {
  // the 32 biases stay in registers for the second pass (ptxas spills about
  // 100 bytes; reading them again from L1 in place spilled 8 and ran 2%
  // slower)
  float bias[32], mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cb + 8 * j + 2 * q + e;
      const bool in = col < vend;
      bias[2 * j + e] = in ? to_f(b[col]) : NEG_INF;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float x = in ? acc[4 * j + 2 * hh + e] + bias[2 * j + e] : NEG_INF;
        if (in && col == tgt[hh]) st[hh] += x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
    const float off = m_new * LOG2E;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rs += cb + 8 * j + 2 * q + e < vend
                  ? exp2_ftz(fmaf(acc[4 * j + 2 * hh + e] + bias[2 * j + e], LOG2E, -off))
                  : 0.f;
    l[hh] = l[hh] * exp2_ftz(fmaf(m[hh], LOG2E, -off)) + quad_sum(rs);
    m[hh] = m_new;
  }
}

struct Ring {
  unsigned char* stages;  // ST x (x box, w slice)
  uint64_t *full, *empty;
};

// One thread issues every load: x's box and w's four boxes a stage.
template <typename TB>
__device__ __forceinline__ void produce(const Args<TB>& a, const Ring& r, int n0, int vbeg,
                                        int tiles, int nd) {
  tma_prefetch_map(&a.maps.x);
  tma_prefetch_map(&a.maps.w);
  for (int i = 0; i < tiles * nd; ++i) {
    const int s = i % ST, v0 = vbeg + i / nd * BV, d0 = i % nd * BD;
    mbar_wait(r.empty + s, ((i / ST) & 1) ^ 1);  // the slot's first wait passes at once
    mbar_expect_tx(r.full + s, STAGE);
    unsigned char* dst = r.stages + s * STAGE;
    tma_load_4d(dst, &a.maps.x, r.full + s, d0, n0, 0, 0);
#pragma unroll
    for (int j = 0; j < BV / 64; ++j)
      tma_load_4d(dst + X_BYTES + j * BD * 128, &a.maps.w, r.full + s, v0 + 64 * j, d0, 0, 0);
  }
}

// Consumer c's 64 rows: the logits of each vocab tile, then its online
// statistics; writes the split's partials and, in the last split of the
// row block to finish, combines them.
template <typename TB>
__device__ __forceinline__ void consume(const Args<TB>& a, const Ring& r, int n0, int vbeg,
                                        int vend, int tiles, int nd) {
  __shared__ int last;
  const int c = threadIdx.x / 128 - 1, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, sp = blockIdx.y;
  const int r0 = n0 + 64 * c + 16 * w + g;  // this thread's rows r0 and r0 + 8
  int tgt[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, st[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) tgt[hh] = r0 + 8 * hh < a.N ? a.t[r0 + 8 * hh] : -1;
  float acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  // x: K-major, a step of 16 along D adds 32 bytes; w: MN-major in column
  // blocks of 64 rows x 128 bytes, a step of 16 along D adds 16 rows
  const uint64_t dx = desc_b128(r.stages + c * 64 * 128, 16, 1024);
  const uint64_t dw = desc_b128(r.stages + X_BYTES, BD * 128, 1024);
  int i = 0;
  for (int t = 0; t < tiles; ++t) {
    // The loop's body has no branch around a wgmma: ptxas serialises every
    // wgmma of a path that diverges around one.
    for (int k = 0; k < nd; ++k, ++i) {
      const int s = i % ST;
      mbar_wait(r.full + s, (i / ST) & 1);
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
      wgmma_fence();
      const uint64_t xs = dx + ((s * STAGE) >> 4), ws = dw + ((s * STAGE) >> 4);
#pragma unroll
      for (int h = 0; h < NH; ++h) {  // one commit group an accumulator
#pragma unroll
        for (int kk = 0; kk < BD / 16; ++kk)
          wgmma_ss<128, 1>(acc[h], xs + ((kk * 32) >> 4),
                           ws + ((h * 2 * BD * 128 + kk * 16 * 128) >> 4), k | kk);
        wgmma_commit();
      }
      wgmma_wait<NH>();  // the last stage's products are done: release it
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
      if (k > 0 && lane == 0) mbar_arrive(r.empty + (i - 1) % ST);
    }
    const int cb = vbeg + t * BV;
    if constexpr (NH == 2) {
      wgmma_wait<1>();  // the first half is done; the second's last products run on
      fence_regs(acc[0]);
      online(acc[0], cb, vend, a.b, tgt, m, l, st, q);
    }
    wgmma_wait<0>();
    fence_regs(acc[NH - 1]);
    if (lane == 0) mbar_arrive(r.empty + (i - 1) % ST);
    online(acc[NH - 1], cb + 128 * (NH - 1), vend, a.b, tgt, m, l, st, q);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float ss = quad_sum(st[hh]);
    const int row = r0 + 8 * hh;
    if (q == 0 && row < a.N) {
      float* p = a.part + (long long)sp * 3 * a.N;
      p[row] = m[hh];
      p[a.N + row] = l[hh];
      p[2 * a.N + row] = ss;
    }
  }
  __threadfence();  // the partials are visible before the count says so
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumers
  if (threadIdx.x == 128) last = atomicAdd(a.count + blockIdx.x, 1) == a.splits - 1;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (!last) return;
  __threadfence();
  combine_splits(a.part, a.N, a.splits, n0, BM, threadIdx.x - 128, 256, a.lse_out, a.loss);
}

// Block (rb, sp) of a (row blocks, splits) grid: rows 128 rb .. + 127 and
// the split's vocab tiles per · sp .. per · sp + per - 1 of BV columns.
template <typename TB>
__global__ void __launch_bounds__(THREADS, 1) ce_fwd_wgmma(const __grid_constant__ Args<TB> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  Ring r;
  r.stages = smem_raw + (((raw + 1023) & ~1023u) - raw);
  r.full = reinterpret_cast<uint64_t*>(r.stages + ST * STAGE);
  r.empty = r.full + ST;
  const int n0 = blockIdx.x * BM, vbeg = blockIdx.y * a.per * BV;
  const int vend = min(a.V, vbeg + a.per * BV);
  const int tiles = (vend - vbeg + BV - 1) / BV, nd = (a.D + BD - 1) / BD;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce(a, r, n0, vbeg, tiles, nd);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume(a, r, n0, vbeg, vend, tiles, nd);
  }
}

}  // namespace wgf

// ------------------------------------------------------------------
// The bf16 backward on mma.sync (the "mma" route): one launch of clusters
// of C = ceil(D / 256) blocks, block r of a cluster owning D columns
// [256 r, 256 r + 256).  dx clusters
// own BM rows, dw clusters BV vocab columns (the wrapper's plan,
// ops/fused_ce.py _bwd_plan).  w is read with its rows ldw apart (the
// forward's staged copy where its rows were not 16-byte aligned, so its
// slices come by 16-byte cp.async); dw is written contiguous, rows V
// apart, by the same bf16 element stores at any V, so an unaligned V
// costs no padded dw and no copy back.
namespace bwd {

using namespace dft::mma;
namespace cg = cooperative_groups;
constexpr int TH = 256;          // 8 warps
constexpr int DS = 256;          // the D columns a block owns
constexpr int XL = DS + 8;       // shared row stride of a (rows, 256) bf16 slice
constexpr int STEP = 64;         // dx: vocab columns a step; dw: rows a step
constexpr int STAGES = 3;        // the cp.async ring
constexpr int MAX_C = 16;        // blocks of a cluster: D <= 4096

struct Args {
  const bf16 *x, *w;
  const void* b;  // f32 or bf16, as b_bf16 says; db the same
  const int* t;
  const float *lse, *g;
  bf16 *dx, *dw;
  void* db;
  int N, D, V, ldw, b_bf16, xvec;  // ldw: w's row stride (>= V); dw's is V
};

// Copy j (of 8 a thread) of staging a (ROWS, COLS) bf16 tile: what
// stage_tile does in one call, cut so that a ring's refill can be issued a
// piece at a time between the products of a step.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_part(bf16* dst, int ldst, const bf16* src, long long lsrc,
                                           int row0, int col0, int nrows, int ncols, int vec,
                                           int j) {
  static_assert(ROWS * COLS / 8 == 8 * TH, "8 copies a thread");
  stage_chunk<COLS>(dst, ldst, src, lsrc, row0, col0, nrows, ncols, vec, threadIdx.x + j * TH);
}

// b[col] as its raw bits, then as f32: a load whose value is not needed at
// once does not hold up the thread that issued it
__device__ __forceinline__ uint32_t bias_bits(const Args& a, int col) {
  return a.b_bf16 ? static_cast<uint32_t>(__ldg(static_cast<const unsigned short*>(a.b) + col))
                  : __ldg(static_cast<const unsigned int*>(a.b) + col);
}
__device__ __forceinline__ float bias_of(const Args& a, uint32_t bits) {
  return __uint_as_float(a.b_bf16 ? bits << 16 : bits);
}
__device__ __forceinline__ float bias(const Args& a, int col) {
  return bias_of(a, bias_bits(a, col));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
}

// acc (the warp's MT x NT tiles of 16 x 8, from (m0, n0)) += A B over k in
// [0, kn): A from a row-major [m][k] tile or, with AT, the transpose of a
// [k][m] tile; B from a row-major [k][n] tile or, with BNK, an [n][k] one.
// Each A fragment serves NT tiles and each B fragment MT.  hook(s) runs
// before k step s.
struct NoHook {
  __device__ void operator()(int) const {}
};
template <int MT, int NT, bool AT, bool BNK, class Hook = NoHook>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const bf16* A, int lda, int m0,
                                         const bf16* B, int ldb, int n0, int kn,
                                         Hook hook = Hook()) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
#pragma unroll 2
  for (int k = 0; k < kn; k += 16) {
    hook(k / 16);  // work of the caller's, issued between this step's products
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (AT) load_a_t(af[mt], A, lda, m0 + 16 * mt, k);
      else load_a(af[mt], A, lda, m0 + 16 * mt, k);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      if constexpr (BNK) load_b_nk(bf, B, ldb, n0 + 16 * np, k);
      else load_b_kn(bf, B, ldb, k, n0 + 16 * np);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        mma(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// The units (8 columns each) of an R x CC logits tile that block `rank`
// finishes: [u0, u0 + nu).  The owner of unit u is the inverse.
template <int CC>
__device__ __forceinline__ void units(int rank, int C, int& u0, int& nu) {
  constexpr int U = CC / 8;
  u0 = rank * U / C;
  nu = (rank + 1) * U / C - u0;
}
template <int CC>
__device__ __forceinline__ int owner(int u, int C) {
  return ((u + 1) * C - 1) / (CC / 8);
}
// The row stride of an owner's slots: its most columns, 8 ceil(U / C).
template <int CC>
__device__ __forceinline__ int slot_cols(int C) {
  return 8 * ((CC / 8 + C - 1) / C);
}
// Where an owner's slots put column c of slot row r: rows of cs columns,
// whose 16-byte chunks are permuted by row (an XOR with (r >> sh) & m,
// when a row's chunks are a power of two; m = 0 otherwise), so that the 8
// rows a warp reads or writes at once meet distinct banks.
struct SlotMap {
  int cs, sh, m;
  __device__ __forceinline__ int at(int r, int c) const {
    return r * cs + ((((c >> 2) ^ ((r >> sh) & m))) << 2) + (c & 3);
  }
};
template <int CC>
__device__ __forceinline__ SlotMap slot_map(int C) {
  const int cs = slot_cols<CC>(C), chunks = cs / 4;
  if (chunks & (chunks - 1)) return SlotMap{cs, 0, 0};
  if (chunks >= 8) return SlotMap{cs, 0, 7};
  return SlotMap{cs, 3 - (__ffs(chunks) - 1), chunks - 1};  // sh = log2(8 / chunks)
}

// Block `rank` sends its partial logits (the warp's MT x NT accumulator
// tiles at (m0, n0) of an R x CC tile, over its 256 columns of D) to the
// blocks that finish them: the columns of owner q's units go to q's slots,
// row (rank R + row), through distributed shared memory.  Stores need no
// reply, so they cost the sender no round trip; the owner reads its slots
// in its own shared memory.
template <int R, int CC, int MT, int NT>
__device__ __forceinline__ void send_partial(cg::cluster_group& cluster, float* slots,
                                             const float (&acc)[MT][NT][4], int m0, int n0,
                                             int rank, int C) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const SlotMap sm = slot_map<CC>(C);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int u = (n0 + 8 * nt) / 8, q = owner<CC>(u, C);
    int u0, nu;
    units<CC>(q, C, u0, nu);
    float* dst = cluster.map_shared_rank(slots, q);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            dst + sm.at(rank * R + m0 + 16 * mt + g + 8 * h, 8 * (u - u0) + 2 * t)) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  }
}

// One row's inputs to dl: its lse, g and target, and whether it exists.
struct Row {
  float lse, g;
  int t;
  bool live;
};

__device__ __forceinline__ Row load_row(const Args& a, int row) {
  if (row >= a.N) return Row{0.f, 0.f, -1, false};
  return Row{a.lse[row], a.g[row], a.t[row], true};
}

// Block `rank` finishes its units of the R x CC logits tile whose columns
// start at c0: thread i takes row i % R (whose inputs are `row`) of the
// units u0 + i / R, u0 + i / R + TH / R, ...  It adds the C blocks' partials
// from its slots in rank order (so every owner's share has the same bits
// however the cluster is scheduled), forms dl = (exp(logit - lse) -
// onehot(t)) g with the tile's bias `sbias` (f32, CC columns), 0 outside N
// and V, and writes dl rounded to bf16 into every block's dl tile (row
// stride DL).  With DB it also leaves the f32 dl in its own slot, which
// only this block reads.  The inputs were loaded a step ahead, so no load
// from device memory waits here.
template <int R, int CC, bool DB>
__device__ __forceinline__ void combine(const Args& a, cg::cluster_group& cluster, float* slots,
                                        bf16* dls, int DL, const float* sbias, const Row& row,
                                        int c0, int rank, int C) {
  static_assert(TH % R == 0, "a thread keeps one row");
  int u0, nu;
  units<CC>(rank, C, u0, nu);
  const int r = threadIdx.x % R;
  const SlotMap sm = slot_map<CC>(C);
  for (int uu = threadIdx.x / R; uu < nu; uu += TH / R) {
    const int u = u0 + uu;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < C; ++q) {
      const float4 v0 = *reinterpret_cast<const float4*>(slots + sm.at(q * R + r, 8 * uu));
      const float4 v1 = *reinterpret_cast<const float4*>(slots + sm.at(q * R + r, 8 * uu + 4));
      s[0] += v0.x; s[1] += v0.y; s[2] += v0.z; s[3] += v0.w;
      s[4] += v1.x; s[5] += v1.y; s[6] += v1.z; s[7] += v1.w;
    }
    float dl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * u + j;
      dl[j] = row.live && col < a.V
                  ? (expf(s[j] + sbias[8 * u + j] - row.lse) - (col == row.t ? 1.f : 0.f)) * row.g
                  : 0.f;
    }
    const uint4 packed = make_uint4(pack(dl[0], dl[1]), pack(dl[2], dl[3]), pack(dl[4], dl[5]),
                                    pack(dl[6], dl[7]));
#pragma unroll 4
    for (int q = 0; q < C; ++q)
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(dls + r * DL + 8 * u, q)) = packed;
    if constexpr (DB) {
      *reinterpret_cast<float4*>(slots + sm.at(rank * R + r, 8 * uu)) =
          make_float4(dl[0], dl[1], dl[2], dl[3]);
      *reinterpret_cast<float4*>(slots + sm.at(rank * R + r, 8 * uu + 4)) =
          make_float4(dl[4], dl[5], dl[6], dl[7]);
    }
  }
}

// Whether C blocks' partials fit `capacity` floats of an owner's slots.
template <int R, int CC>
__host__ __device__ constexpr bool slots_fit(int C, int capacity) {
  return C * R * 8 * ((CC / 8 + C - 1) / C) <= capacity;
}

// Shared memory of the two roles, in bytes.
template <int BM>
struct DxTile {
  static constexpr int WL = STEP + 8;
  static constexpr int SLOTS = 8192;  // floats: C in {1, 2, 4, 8} at BM 128, any at 64
  // x rows (BM, 256), the ring of w slices (256, 64), dl (BM, 64) bf16;
  // the slots and the step's bias (64) f32
  static constexpr int SMEM = (BM * XL + STAGES * DS * WL + BM * WL) * 2 + (SLOTS + STEP) * 4;
};
template <int BV>
struct DwTile {
  static constexpr int WL = BV + 8;
  static constexpr int SLOTS = BV == 128 ? 10240 : 8192;  // floats
  // the w slice (256, BV), the ring of x slices (64, 256), dl (64, BV)
  // bf16; the slots, the db group sums and the bias (BV) f32
  static constexpr int SMEM =
      (DS * WL + STAGES * STEP * XL + STEP * WL) * 2 + (SLOTS + TH + BV) * 4;
};

// dx of rows [n0, n0 + BM), columns [256 rank, + 256): the block keeps
// that slice of dx in registers and its x slice resident; per vocab step
// of 64 it takes its (256, 64) slice of w from the ring, computes its
// partial logits and sends them to their owners, meets the cluster for
// dl, and adds dl w^T.
template <int BM>
__device__ __forceinline__ void dx_role(const Args& a, int n0, int rank, int C,
                                        unsigned char* smem) {
  constexpr int WL = DxTile<BM>::WL;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + BM * XL;
  bf16* dls = ws + STAGES * DS * WL;
  float* slots = reinterpret_cast<float*>(dls + BM * WL);
  float* sbias = slots + DxTile<BM>::SLOTS;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, l = tid % 32, g = l / 4, t = l % 4;
  const int d0 = rank * DS, nv = (a.V + STEP - 1) / STEP;
  const Row row = load_row(a, n0 + tid % BM);  // the row this thread finishes dl for
  // the bias of the step's 64 columns goes to shared memory a step after
  // thread tid < 64 loads it
  uint32_t next_bias = tid < STEP && tid < a.V ? bias_bits(a, tid) : 0u;
  // copy j of the ring's slice for step i (8 a thread)
  auto fetch = [&](int i, int j) {
    stage_part<DS, STEP>(ws + (i % STAGES) * DS * WL, WL, a.w, a.ldw, d0, i * STEP, a.D, a.V,
                         1, j);
  };
  stage_tile<BM, DS, TH>(xs, XL, a.x, a.D, n0, d0, a.N, a.D, a.xvec);
  for (int j = 0; j < 8; ++j) fetch(0, j);
  cp_async_commit();
  for (int j = 0; j < 8 && nv > 1; ++j) fetch(1, j);
  cp_async_commit();
  // logits (BM, 64): warps (BM / 32) x LWC, each 32 x (64 / LWC)
  constexpr int LWC = 8 / (BM / 32), LNT = STEP / LWC / 8;
  const int lm = (warp / LWC) * 32, ln = (warp % LWC) * (STEP / LWC);
  // dx (BM, 256): warps 2 x 4, each (BM / 2) x 64
  constexpr int MT = BM / 32;
  const int pm = (warp / 4) * (BM / 2), pn = (warp % 4) * 64;
  float acc[MT][8][4];
  zero(acc);
  for (int i = 0; i < nv; ++i) {
    cp_async_wait_one();  // step i's slice (and, at i = 0, x) has landed
    __syncthreads();      // ... for every thread; step i - 1's stage is free
    if (tid < STEP) {
      const int col = (i + 1) * STEP + tid;
      sbias[tid] = bias_of(a, next_bias);
      next_bias = col < a.V ? bias_bits(a, col) : 0u;
    }
    const bf16* wsi = ws + (i % STAGES) * DS * WL;
    {
      float lg[2][LNT][4];
      zero(lg);
      // step i + 2's slice is issued a copy at a time between the products
      warp_mma<2, LNT, false, false>(lg, xs, XL, lm, wsi, WL, ln, DS, [&](int s) {
        if (s % 2 == 0 && i + 2 < nv) fetch(i + 2, s / 2);
      });
      cp_async_commit();
      send_partial<BM, STEP>(cluster, slots, lg, lm, ln, rank, C);
    }
    cluster.sync();  // every partial has reached its owner; every block is done with the last dl
    combine<BM, STEP, false>(a, cluster, slots, dls, WL, sbias, row, i * STEP, rank, C);
    cluster.sync();  // dl is whole in every block; every slot has been read
    warp_mma<MT, 8, false, true>(acc, dls, WL, pm, wsi, WL, pn, STEP);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = n0 + pm + 16 * mt + g + 8 * h;
      if (r >= a.N) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = d0 + pn + 8 * nt + 2 * t;
        bf16* o = a.dx + (long long)r * a.D + col;
        if (col < a.D) o[0] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
        if (col + 1 < a.D) o[1] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
      }
    }
}

// dw of vocab columns [v0, v0 + BV) and rows [256 rank, + 256) of D, and
// db of this block's units of those columns: the block keeps that slice
// of dw in registers and its w slice resident; per step of 64 rows it
// takes its (64, 256) slice of x from the ring, computes its partial
// logits and sends them to their owners, meets the cluster for dl, adds
// x^T dl and sums db.
template <int BV>
__device__ __forceinline__ void dw_role(const Args& a, int v0, int rank, int C,
                                        unsigned char* smem) {
  constexpr int WL = DwTile<BV>::WL;
  bf16* wres = reinterpret_cast<bf16*>(smem);
  bf16* xr = wres + DS * WL;
  bf16* dls = xr + STAGES * STEP * XL;
  float* slots = reinterpret_cast<float*>(dls + STEP * WL);
  float* red = slots + DwTile<BV>::SLOTS;
  float* sbias = red + TH;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, l = tid % 32, g = l / 4, t = l % 4;
  const int d0 = rank * DS, nr = (a.N + STEP - 1) / STEP;
  for (int c = tid; c < BV; c += TH) sbias[c] = v0 + c < a.V ? bias(a, v0 + c) : 0.f;
  // the inputs of the row this thread finishes dl for, loaded a step ahead
  Row next_row = load_row(a, tid % STEP);
  // copy j of the ring's slice for step i (8 a thread)
  auto fetch = [&](int i, int j) {
    stage_part<STEP, DS>(xr + (i % STAGES) * STEP * XL, XL, a.x, a.D, i * STEP, d0, a.N, a.D,
                         a.xvec, j);
  };
  stage_tile<DS, BV, TH>(wres, WL, a.w, a.ldw, d0, v0, a.D, a.V, 1);
  for (int j = 0; j < 8; ++j) fetch(0, j);
  cp_async_commit();
  for (int j = 0; j < 8 && nr > 1; ++j) fetch(1, j);
  cp_async_commit();
  // logits (64, BV): warps 2 x 4, each 32 x (BV / 4)
  constexpr int LNT = BV / 32;
  const int lm = (warp / 4) * 32, ln = (warp % 4) * (BV / 4);
  // dw (256, BV): warps 4 x 2, each 64 x (BV / 2)
  constexpr int NT = BV / 16;
  const int pm = (warp / 2) * 64, pn = (warp % 2) * (BV / 2);
  // db of this block's ncols columns: `groups` threads a column each sum a
  // range of rows of its own slot, then thread c < ncols adds the groups
  // in order
  int u0, nu;
  units<BV>(rank, C, u0, nu);
  const SlotMap sm = slot_map<BV>(C);
  const int ncols = 8 * nu, groups = ncols ? TH / ncols : 0;
  const int rpg = groups ? (STEP + groups - 1) / groups : 0;
  const int dbc = ncols ? tid % ncols : 0, dbg = ncols ? tid / ncols : groups;
  float acc[4][NT][4], dbacc = 0.f;
  zero(acc);
  for (int i = 0; i < nr; ++i) {
    cp_async_wait_one();  // step i's slice (and, at i = 0, w) has landed
    __syncthreads();      // ... for every thread; step i - 1's stage is free
    const Row row = next_row;
    next_row = load_row(a, (i + 1) * STEP + tid % STEP);
    const bf16* xsi = xr + (i % STAGES) * STEP * XL;
    {
      float lg[2][LNT][4];
      zero(lg);
      // step i + 2's slice is issued a copy at a time between the products
      warp_mma<2, LNT, false, false>(lg, xsi, XL, lm, wres, WL, ln, DS, [&](int s) {
        if (s % 2 == 0 && i + 2 < nr) fetch(i + 2, s / 2);
      });
      cp_async_commit();
      send_partial<STEP, BV>(cluster, slots, lg, lm, ln, rank, C);
    }
    cluster.sync();  // every partial has reached its owner; every block is done with the last dl
    combine<STEP, BV, true>(a, cluster, slots, dls, WL, sbias, row, v0, rank, C);
    __syncthreads();  // this block's f32 dl is in its own slot
    if (dbg < groups) {
      float s = 0.f;
      const int r1 = min(STEP, (dbg + 1) * rpg);
      for (int r = dbg * rpg; r < r1; ++r) s += slots[sm.at(rank * STEP + r, dbc)];
      red[dbg * ncols + dbc] = s;
    }
    cluster.sync();  // dl is whole in every block; every slot has been read
    if (tid < ncols)
      for (int q = 0; q < groups; ++q) dbacc += red[q * ncols + tid];
    warp_mma<4, NT, true, false>(acc, xsi, XL, pm, dls, WL, pn, STEP);
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + pm + 16 * mt + g + 8 * h;
      if (d >= a.D) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = v0 + pn + 8 * nt + 2 * t;
        bf16* o = a.dw + (long long)d * a.V + col;
        if (col < a.V) o[0] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
        if (col + 1 < a.V) o[1] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
      }
    }
  const int col = v0 + 8 * u0 + tid;
  if (tid < ncols && col < a.V) {
    if (a.b_bf16) static_cast<bf16*>(a.db)[col] = __float2bfloat16_rn(dbacc);
    else static_cast<float*>(a.db)[col] = dbacc;
  }
}

// Grid (C, dx clusters + dw clusters), clusters of (C, 1, 1): blockIdx.x is
// the block's rank.  The role whose clusters run longer comes first.
template <int BM, int BV>
__global__ void __launch_bounds__(TH, 1)
ce_bwd_cluster(const __grid_constant__ Args a, int ndx, int dx_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x, C = gridDim.x, ndw = gridDim.y - ndx, cl = blockIdx.y;
  if (dx_first ? cl < ndx : cl >= ndw)
    dx_role<BM>(a, (dx_first ? cl : cl - ndw) * BM, rank, C, smem);
  else
    dw_role<BV>(a, (dx_first ? cl - ndx : cl) * BV, rank, C, smem);
}

template <int BM, int BV>
cudaError_t launch(const Args& a, int C, cudaStream_t st) {
  constexpr int smem = DxTile<BM>::SMEM > DwTile<BV>::SMEM ? DxTile<BM>::SMEM : DwTile<BV>::SMEM;
  auto kernel = ce_bwd_cluster<BM, BV>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8)  // a cluster past the portable 8 blocks, on the current card
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  const int ndx = (a.N + BM - 1) / BM, ndw = (a.V + BV - 1) / BV;
  if (ndx + ndw > 65535) return cudaErrorInvalidValue;
  // a dx cluster walks V in steps of 64 for BM rows, a dw cluster N for BV columns
  const int dx_first = (long long)((a.V + STEP - 1) / STEP) * BM >=
                       (long long)((a.N + STEP - 1) / STEP) * BV;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, ndx + ndw);
  cfg.blockDim = dim3(TH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, ndx, dx_first);
}

// The plan (C, BM, BV): C = ceil(D / 256) up to 16, BM and BV 128 or 64
// with the C blocks' partials fitting the owners' slots; any other is
// refused.
cudaError_t run(const Args& a, int C, int BM, int BV, cudaStream_t st) {
  if (a.N < 1 || a.D < 1 || a.V < 1 || C < 1 || C > MAX_C || C != (a.D + DS - 1) / DS)
    return cudaErrorInvalidValue;
  const bool dx_fits = BM == 128 ? slots_fit<128, STEP>(C, DxTile<128>::SLOTS)
                                  : slots_fit<64, STEP>(C, DxTile<64>::SLOTS);
  const bool dw_fits = BV == 128 ? slots_fit<STEP, 128>(C, DwTile<128>::SLOTS)
                                  : slots_fit<STEP, 64>(C, DwTile<64>::SLOTS);
  if (!dx_fits || !dw_fits) return cudaErrorInvalidValue;
  if (BM == 128 && BV == 128) return launch<128, 128>(a, C, st);
  if (BM == 128 && BV == 64) return launch<128, 64>(a, C, st);
  if (BM == 64 && BV == 128) return launch<64, 128>(a, C, st);
  if (BM == 64 && BV == 64) return launch<64, 64>(a, C, st);
  return cudaErrorInvalidValue;
}

}  // namespace bwd

// ------------------------------------------------------------------
// The bf16 backward on Hopper's tensor cores: the clusters of namespace
// bwd (C = ceil(D / 256) blocks, block r owning D columns [256 r, 256 r +
// 256)), with wgmma fed by TMA and warp-specialised blocks.  A block is a
// producer warpgroup (one thread issues every TMA load) and two consumer
// warpgroups; each consumer is a pipeline of its own over a 64 x 64 tile a
// step, exchanging its partial logits with the same consumer of the
// cluster's other blocks through distributed shared memory (st.async
// stores that count their bytes on the receiver's mbarrier, as TMA loads
// do; no cluster-wide barrier, no release fence), so while one consumer
// sends, waits and combines, the other's products run on the tensor
// cores.
//
// A dx cluster owns 128 rows (64 a consumer) and walks the vocabulary in
// steps of 64: each block keeps its (128, 256) slice of x resident and the
// producer streams the (256, 64) slices of w through a ring of ST stages
// of one TMA box each.  A dw cluster owns 128 vocab columns (64 a
// consumer) and walks the rows in steps of 64: its (256, 128) slice of w
// is resident and (64, 256) slices of x stream.  Both operands are
// 128-byte swizzled, zeros past N, D and V, and one staged slice serves
// both products of a step:
// - dx role: logits (64, 64) = x_slice (K-major) w_slice (MN-major, the
//   transpose-B bit), then dx (64, 256) += dl (K-major) w_slice^T (the
//   same bytes read K-major), two accumulators of 128 columns;
// - dw role: logits (64, 64) = x_slice (K-major) w_slice (MN-major), then
//   dw (256, 64) += x_slice^T (MN-major, the transpose-A bit) dl
//   (MN-major), four accumulators of 64 rows.
// A step's exchange: each consumer stores its partial logits into the
// slots of the blocks that finish them (unit u of 8 columns belongs to
// block owner(u), as in bwd), counted on their `part` barriers; each owner
// adds the C partials of its units in rank order, forms dl = (exp(logit +
// b - lse) - onehot(t)) g (0 past N and V; exp by ex2.approx, as the wgmma
// forward) and stores it in bf16 into every block's dl tile (the swizzled
// layout wgmma reads), counted on their `dlb` barriers; the consumer then
// adds its product.  A
// consumer issues step i + 1's logits before it waits for step i's
// partials, so they run on the tensor cores while it combines; it sends
// step i + 1's partials only after its own step i product is done and
// after every owner's dl of step i arrived (which the owners wrote after
// reading their slots), so one slot array and one dl tile a consumer
// suffice.  db is summed from the f32 dl by the owners, each
// column in a fixed order.  No float atomics: two calls give the same
// bits.  The plan (C, 128, ST) is the wrapper's (ops/fused_ce.py
// _bwd_wgmma_plan): ST = 3 where the partials of C blocks fit 6,144 floats
// a consumer, else 2 with 8,192.  What bounds it now: the exchange's
// latency, about 3,900 cycles a step (the stores, both waits and the
// combine) beside about 1,100 of tensor work, which the other consumer
// and the early logits only partly hide; a second slot array and dl
// tile, so that a consumer's sends run a step ahead of its exchange, do
// not fit shared memory at C = 3 beside a 3-stage ring (PERF.md).
namespace bwg {

using namespace dft::hopper;
using dft::mma::bf16;
using dft::mma::pack;
namespace cg = cooperative_groups;

constexpr int DS = 256;        // the D columns a block owns
constexpr int STEP = 64;       // vocab columns (dx) or rows (dw) a step, and a consumer's share
constexpr int TILE = 128;      // a cluster's rows (dx) or vocab columns (dw): two consumers
constexpr int UNITS = STEP / 8;
constexpr int MAX_C = 16;      // blocks of a cluster: D <= 4096
constexpr int THREADS = 384;   // the producer warpgroup and two consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int HALF = 32768;    // a consumer's resident slice, and a stage of the ring
constexpr int BOX = 8192;      // a 64 x 64 box, and a consumer's dl tile

// Shared memory, 1024-byte aligned: the two resident slices, the ring, the
// two dl tiles, then f32 slots, biases and the barriers (res, full[ST],
// empty[ST], part[2], dlb[2]).
template <int ST>
struct Layout {
  static constexpr int SLOTS = ST == 3 ? 6144 : 8192;  // floats of a consumer's slots
  static constexpr int RING = 2 * HALF;
  static constexpr int DL = RING + ST * HALF;
  static constexpr int SLOT = DL + 2 * BOX;
  static constexpr int BIAS = SLOT + 2 * SLOTS * 4;  // dx: [2][2][64], dw: [128] f32
  static constexpr int BARS = BIAS + 4 * STEP * 4;
  static constexpr int SMEM = 1024 + BARS + (1 + 2 * ST + 4) * 8;
};

struct Args {
  CUtensorMap xmap, wmap;  // first: 64-byte aligned.  x (D, N) in boxes of 64 x 64,
                           // w (V, D) in boxes of 64 x 256
  const void* b;           // f32 or bf16, as b_bf16 says; db the same
  const int* t;
  const float *lse, *g;
  bf16 *dx, *dw;
  void* db;
  int N, D, V, b_bf16;
};

__device__ __forceinline__ uint32_t bias_bits(const Args& a, int col) {
  return a.b_bf16 ? static_cast<uint32_t>(__ldg(static_cast<const unsigned short*>(a.b) + col))
                  : __ldg(static_cast<const unsigned int*>(a.b) + col);
}
__device__ __forceinline__ float bias_of(const Args& a, uint32_t bits) {
  return __uint_as_float(a.b_bf16 ? bits << 16 : bits);
}

struct Row {
  float lse, g;
  int t;
  bool live;
};

__device__ __forceinline__ Row load_row(const Args& a, int row) {
  if (row >= a.N) return Row{0.f, 0.f, -1, false};
  return Row{a.lse[row], a.g[row], a.t[row], true};
}

// p's address in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
// Stores into the shared memory of a block of the cluster (cluster
// addresses) that count their bytes on the barrier `bar` of that block, as
// a TMA load does: the receiver waits on its barrier, the sender waits for
// nothing (no release fence, no arrival).
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// mbar_wait, acquiring at cluster scope what the stores released
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Consumer c's part of the exchange in this block.  Its barriers `part`
// (the partials of its units have landed in its slots) and `dlb` (its dl
// tile is whole) take one arrival a phase, the consumer's own, which also
// sets the bytes to come.
struct Exchange {
  float* slots;        // [C senders][64 rows][cs], in bwd::SlotMap order
  unsigned char* dl;   // its dl tile, 64 x 64 bf16, 128-byte swizzled
  uint64_t *part, *dlb;
  int rank, C, u0, nu;  // this block's units of a step: [u0, u0 + nu)
  bwd::SlotMap map;     // of every block's slots
  // unit j's owner (4 bits each) and its place among the owner's units
  // (3 bits each): what send needs, without a division a step
  uint32_t owners, places;
};

// Waits for phase i of a consumer's barrier, which counts `bytes` of
// st_async stores; the consumer's thread 0 arrives and sets the count.
__device__ __forceinline__ void await_bytes(uint64_t* bar, uint32_t bytes, int i) {
  if (threadIdx.x % 128 == 0) mbar_expect_tx(bar, bytes);
  wait_cluster(bar, i & 1);
}

template <int ST>
__device__ __forceinline__ Exchange exchange(unsigned char* sm, int c, int rank, int C) {
  using L = Layout<ST>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS) + 1 + 2 * ST;
  Exchange e;
  e.slots = reinterpret_cast<float*>(sm + L::SLOT) + c * L::SLOTS;
  e.dl = sm + L::DL + c * BOX;
  e.part = bars + c;
  e.dlb = bars + 2 + c;
  e.rank = rank;
  e.C = C;
  bwd::units<STEP>(rank, C, e.u0, e.nu);
  e.map = bwd::slot_map<STEP>(C);
  e.owners = e.places = 0u;
  for (int j = 0; j < UNITS; ++j) {
    const int o = bwd::owner<STEP>(j, C);
    int u0, nu;
    bwd::units<STEP>(o, C, u0, nu);
    e.owners |= static_cast<uint32_t>(o) << (4 * j);
    e.places |= static_cast<uint32_t>(j - u0) << (3 * j);
  }
  return e;
}

// The consumer's partial logits (a 64 x 64 accumulator over this block's
// 256 columns of D) to the blocks that finish them: unit u to its owner's
// slots, rows 64 rank .. + 63, counted on the owner's `part` barrier.  A
// lane pair trades halves first, so that each lane stores 4 adjacent
// columns of one row (16 bytes): the even lane row g, the odd row g + 8.
__device__ __forceinline__ void send(const Exchange& e, const float (&lg)[32]) {
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const bool odd = q & 1;
  const int row = 64 * e.rank + 16 * w + g + (odd ? 8 : 0);
  const int rowoff = row * e.map.cs, rowx = (row >> e.map.sh) & e.map.m;
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    const float give0 = odd ? lg[4 * j] : lg[4 * j + 2], give1 = odd ? lg[4 * j + 1] : lg[4 * j + 3];
    const float got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
    const float got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
    const uint4 v = odd ? make_uint4(__float_as_uint(got0), __float_as_uint(got1),
                                     __float_as_uint(lg[4 * j + 2]), __float_as_uint(lg[4 * j + 3]))
                        : make_uint4(__float_as_uint(lg[4 * j]), __float_as_uint(lg[4 * j + 1]),
                                     __float_as_uint(got0), __float_as_uint(got1));
    const int o = (e.owners >> (4 * j)) & 15;
    const int chunk = 2 * ((e.places >> (3 * j)) & 7) + (q >> 1);  // 16-byte chunk in the row
    st_async(cluster_addr(e.slots, o) + 4 * (rowoff + ((chunk ^ rowx) << 2)), v,
             cluster_addr(e.part, o));
  }
}

// the bytes of partials an owner's `part` barrier counts a step
__device__ __forceinline__ uint32_t part_bytes(const Exchange& e) {
  return e.C * STEP * 8 * e.nu * 4;
}

// This block's units of the consumer's step, once every partial is in its
// slots: thread i of the consumer takes row r = i % 64 (whose inputs are
// `row`) of units u0 + i / 64, u0 + i / 64 + 2, ...; it adds the C partials
// in rank order, forms dl with the step's biases `bias` (f32, 64 columns
// from c0), and stores it in bf16 into every block's dl tile (counted on
// its `dlb` barrier).  With DB it adds the f32 dl into dbacc (by unit of
// the thread, then column).
template <bool DB>
__device__ __forceinline__ void combine(const Exchange& e, const Row& row, int c0, int V,
                                        const float* bias, float (&dbacc)[4][8]) {
  const int i = threadIdx.x % 128, r = i % 64;
  // slot row 64 q + r has row r's swizzle for every sender q
  const int stride = 64 * e.map.cs, rowx = (r >> e.map.sh) & e.map.m;
  const float lse2 = row.lse * wgf::LOG2E;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int uu = i / 64 + 2 * k;
    if (uu >= e.nu) break;
    const int u = e.u0 + uu;
    const float* p0 = e.slots + r * e.map.cs + (((2 * uu) ^ rowx) << 2);
    const float* p1 = e.slots + r * e.map.cs + (((2 * uu + 1) ^ rowx) << 2);
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < e.C; ++q) {
      const float4 v0 = *reinterpret_cast<const float4*>(p0 + q * stride);
      const float4 v1 = *reinterpret_cast<const float4*>(p1 + q * stride);
      s[0] += v0.x; s[1] += v0.y; s[2] += v0.z; s[3] += v0.w;
      s[4] += v1.x; s[5] += v1.y; s[6] += v1.z; s[7] += v1.w;
    }
    float dl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * u + j;
      const float p = wgf::exp2_ftz(fmaf(s[j] + bias[8 * u + j], wgf::LOG2E, -lse2));
      dl[j] = row.live && col < V ? (p - (col == row.t ? 1.f : 0.f)) * row.g : 0.f;
      if constexpr (DB) dbacc[k][j] += dl[j];
    }
    const uint4 packed = make_uint4(pack(dl[0], dl[1]), pack(dl[2], dl[3]), pack(dl[4], dl[5]),
                                    pack(dl[6], dl[7]));
    const uint32_t off = r * 128 + ((u ^ (r & 7)) << 4);  // the 128-byte swizzle
    for (int o = 0; o < e.C; ++o)
      st_async(cluster_addr(e.dl, o) + off, packed, cluster_addr(e.dlb, o));
  }
}

// Waits until the dl tile of step i is whole (64 x 64 bf16 from the
// owners); then wgmma, through the async proxy, may read it.
__device__ __forceinline__ void dl_ready(const Exchange& e, int i) {
  await_bytes(e.dlb, BOX, i);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread issues every load: the resident slices on `res`, then a
// stage a step.
template <int ST>
__device__ __forceinline__ void produce(const Args& a, unsigned char* sm, bool dx, int base,
                                        int rank) {
  using L = Layout<ST>;
  uint64_t* res = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *full = res + 1, *empty = full + ST;
  tma_prefetch_map(&a.xmap);
  tma_prefetch_map(&a.wmap);
  const int d0 = rank * DS;
  mbar_expect_tx(res, 2 * HALF);
  for (int c = 0; c < 2; ++c) {
    if (dx) {  // x rows base + 64 c .. + 63, D columns d0 .. d0 + 255: four boxes
      for (int kb = 0; kb < 4; ++kb)
        tma_load_4d(sm + c * HALF + kb * BOX, &a.xmap, res, d0 + 64 * kb, base + 64 * c, 0, 0);
    } else {   // w vocab columns base + 64 c .. + 63, D rows d0 .. d0 + 255: one box
      tma_load_4d(sm + c * HALF, &a.wmap, res, base + 64 * c, d0, 0, 0);
    }
  }
  const int n = dx ? (a.V + STEP - 1) / STEP : (a.N + STEP - 1) / STEP;
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    mbar_wait(empty + s, ((i / ST) & 1) ^ 1);  // the slot's first wait passes at once
    mbar_expect_tx(full + s, HALF);
    unsigned char* dst = sm + L::RING + s * HALF;
    if (dx) {
      tma_load_4d(dst, &a.wmap, full + s, STEP * i, d0, 0, 0);
    } else {
      for (int kb = 0; kb < 4; ++kb)
        tma_load_4d(dst + kb * BOX, &a.xmap, full + s, d0 + 64 * kb, STEP * i, 0, 0);
    }
  }
}

// dx of rows n0 + 64 c .. + 63 and this block's 256 columns of D.  Step
// i + 1's logits run on the tensor cores while the consumer waits for and
// combines step i's partials; its dx product then ends with them, and only
// then go step i + 1's partials (so one slot array and one dl tile serve).
template <int ST>
__device__ __forceinline__ void consume_dx(const Args& a, unsigned char* sm, int n0, int rank,
                                           int C) {
  using L = Layout<ST>;
  const int c = threadIdx.x / 128 - 1, i = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = i / 32, g = lane / 4, q = lane % 4;
  uint64_t* res = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *full = res + 1, *empty = full + ST;
  const Exchange e = exchange<ST>(sm, c, rank, C);
  // the biases of a step's 64 columns, double-buffered: thread i < 64
  // stores step s + 1's (loaded a step ahead) just before step s + 1's
  // partials go, then the consumer meets at its named barrier 2 + c
  float* sbias = reinterpret_cast<float*>(sm + L::BIAS) + c * 2 * STEP;
  const int nv = (a.V + STEP - 1) / STEP;
  const Row row = load_row(a, n0 + 64 * c + i % 64);
  uint32_t next = 0u;
  if (i < STEP) {
    sbias[i] = i < a.V ? bias_of(a, bias_bits(a, i)) : 0.f;
    next = STEP + i < a.V ? bias_bits(a, STEP + i) : 0u;
  }
  // no accumulator is zeroed: the first products take scale_d 0 (an
  // instruction that writes one while the other's products are in flight
  // makes ptxas serialise every wgmma, C7515)
  float acc[2][64], lg[32], none[4][8];
  // x slice K-major (a step of 16 along D adds 32 bytes, a box 8 KB); the
  // stage's w slice MN-major for the logits (16 rows of D: 2 KB) and
  // K-major for dx (16 vocab columns: 32 bytes; 128 rows of D: 16 KB); dl
  // K-major
  const uint64_t xa = desc_b128(sm + c * HALF, 16, 1024);
  const uint64_t wmn = desc_b128(sm + L::RING, BOX, 1024);
  const uint64_t wk = desc_b128(sm + L::RING, 16, 1024);
  const uint64_t da = desc_b128(e.dl, 16, 1024);
  auto logits = [&](int it) {  // step it's, on the tensor cores
    const uint64_t so = ((it % ST) * HALF) >> 4;
    mbar_wait(full + it % ST, (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss<64, 1>(lg, xa + (((kk / 4) * BOX + (kk % 4) * 32) >> 4),
                      wmn + so + ((kk * 2048) >> 4), kk);
    wgmma_commit();
  };
  auto send_next = [&](int it) {  // step it's biases stored, its partials sent
    if (i < STEP) {
      sbias[(it & 1) * STEP + i] = bias_of(a, next);
      const int col = (it + 1) * STEP + i;
      next = col < a.V ? bias_bits(a, col) : 0u;
    }
    send(e, lg);
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  };
  auto product = [&](int it) {  // step it's combine and dx product, issued
    await_bytes(e.part, part_bytes(e), it);
    combine<false>(e, row, it * STEP, a.V, sbias + (it & 1) * STEP, none);
    dl_ready(e, it);
    wgmma_fence();
    const uint64_t so = ((it % ST) * HALF) >> 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_ss<128, 0>(acc[h], da + ((kk * 32) >> 4), wk + so + ((h * 16384 + kk * 32) >> 4),
                         it | kk);
    wgmma_commit();
  };
  mbar_wait(res, 0);
  logits(0);
  wgmma_wait<0>();
  fence_regs(lg);
  send(e, lg);  // step 0's biases were stored before
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  for (int it = 0; it + 1 < nv; ++it) {
    logits(it + 1);
    product(it);
    wgmma_wait<0>();  // step it + 1's logits and step it's dx product
    fence_regs(lg);
    if (lane == 0) mbar_arrive(empty + it % ST);
    send_next(it + 1);
  }
  product(nv - 1);
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + 64 * c + 16 * w + g + 8 * hh;
    if (r >= a.N) continue;
    bf16* o = a.dx + (long long)r * a.D;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = rank * DS + 128 * h + 8 * j + 2 * q;  // D is even: col + 1 < D too
        if (col < a.D)
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(acc[h][4 * j + 2 * hh], acc[h][4 * j + 2 * hh + 1]);
      }
  }
}

// dw of vocab columns v0 + 64 c .. + 63 and this block's 256 rows of D,
// and db of this block's units of those columns; steps overlap as
// consume_dx's.
template <int ST>
__device__ __forceinline__ void consume_dw(const Args& a, unsigned char* sm, int v0, int rank,
                                           int C) {
  using L = Layout<ST>;
  const int c = threadIdx.x / 128 - 1, i = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = i / 32, g = lane / 4, q = lane % 4;
  uint64_t* res = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t *full = res + 1, *empty = full + ST;
  const Exchange e = exchange<ST>(sm, c, rank, C);
  const int cb = v0 + 64 * c, nr = (a.N + STEP - 1) / STEP;
  const float* sbias = reinterpret_cast<const float*>(sm + L::BIAS) + 64 * c;  // the kernel's
  Row row = load_row(a, i % 64), next = load_row(a, STEP + i % 64);  // a step ahead
  float acc[4][32], lg[32], dbacc[4][8];  // acc as consume_dx's: scale_d 0 first
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) dbacc[k][j] = 0.f;
  // the stage's x slice K-major for the logits and MN-major (A transposed,
  // a box of 64 D rows each) for dw; the w slice and dl MN-major
  const uint64_t xk = desc_b128(sm + L::RING, 16, 1024);
  const uint64_t xm = desc_b128(sm + L::RING, BOX, 1024);
  const uint64_t wmn = desc_b128(sm + c * HALF, BOX, 1024);
  const uint64_t dlm = desc_b128(e.dl, BOX, 1024);
  auto logits = [&](int it) {
    const uint64_t so = ((it % ST) * HALF) >> 4;
    mbar_wait(full + it % ST, (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss<64, 1>(lg, xk + so + (((kk / 4) * BOX + (kk % 4) * 32) >> 4),
                      wmn + ((kk * 2048) >> 4), kk);
    wgmma_commit();
  };
  auto product = [&](int it) {
    await_bytes(e.part, part_bytes(e), it);
    combine<true>(e, row, cb, a.V, sbias, dbacc);
    row = next;
    next = load_row(a, (it + 2) * STEP + i % 64);
    dl_ready(e, it);
    wgmma_fence();
    const uint64_t so = ((it % ST) * HALF) >> 4;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 1, 1>(acc[m], xm + so + ((m * BOX + kk * 2048) >> 4),
                           dlm + ((kk * 2048) >> 4), it | kk);
    wgmma_commit();
  };
  mbar_wait(res, 0);
  logits(0);
  wgmma_wait<0>();
  fence_regs(lg);
  send(e, lg);
  for (int it = 0; it + 1 < nr; ++it) {
    logits(it + 1);
    product(it);
    wgmma_wait<0>();  // step it + 1's logits and step it's dw product
    fence_regs(lg);
    if (lane == 0) mbar_arrive(empty + it % ST);
    send(e, lg);
  }
  product(nr - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
  // db: over each warp's 32 rows by a fixed tree, then the two warps of a
  // row group in order, in the slots (every partial has been read once the
  // consumer has passed its last combine)
  const int bar_id = 2 + c;
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
  float* red = e.slots;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = dbacc[k][j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[(w * 4 + k) * 8 + j] = v;
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
  for (int x = i; x < 8 * e.nu; x += 128) {
    const int uu = x / 8, j = x % 8, grp = uu % 2, k = uu / 2;  // warps 2 grp, 2 grp + 1
    const float v = red[(2 * grp * 4 + k) * 8 + j] + red[((2 * grp + 1) * 4 + k) * 8 + j];
    const int col = cb + 8 * (e.u0 + uu) + j;
    if (col < a.V) {
      if (a.b_bf16) static_cast<bf16*>(a.db)[col] = __float2bfloat16_rn(v);
      else static_cast<float*>(a.db)[col] = v;
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = rank * DS + 64 * m + 16 * w + g + 8 * hh;
      if (d >= a.D) continue;
      bf16* o = a.dw + (long long)d * a.V;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb + 8 * j + 2 * q;
        if (col < a.V) o[col] = __float2bfloat16_rn(acc[m][4 * j + 2 * hh]);
        if (col + 1 < a.V) o[col + 1] = __float2bfloat16_rn(acc[m][4 * j + 2 * hh + 1]);
      }
    }
}

// Grid (C, dx clusters + dw clusters), clusters of (C, 1, 1): blockIdx.x is
// the block's rank.  The role whose clusters run longer comes first.
template <int ST>
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_wgmma(const __grid_constant__ Args a, int ndx, int dx_first) {
  using L = Layout<ST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);  // the same in every block
  const int rank = blockIdx.x, C = gridDim.x, ndw = gridDim.y - ndx, cl = blockIdx.y;
  const bool dx = dx_first ? cl < ndx : cl >= ndw;
  const int base = (dx ? (dx_first ? cl : cl - ndw) : (dx_first ? cl - ndx : cl)) * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 1 + s, 1);
      mbar_init(bars + 1 + ST + s, 8);  // one arrival from each consumer warp
    }
    for (int k = 0; k < 4; ++k) mbar_init(bars + 1 + 2 * ST + k, 1);  // part, dlb
    mbar_fence_init();
  }
  if (!dx) {  // the dw role's biases, fixed for the whole walk
    float* sbias = reinterpret_cast<float*>(sm + L::BIAS);
    for (int k = threadIdx.x; k < TILE; k += THREADS)
      sbias[k] = base + k < a.V ? bias_of(a, bias_bits(a, base + k)) : 0.f;
  }
  // every block's barriers are initialised before any arrives from another
  cg::this_cluster().sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce<ST>(a, sm, dx, base, rank);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    if (dx)
      consume_dx<ST>(a, sm, base, rank, C);
    else
      consume_dw<ST>(a, sm, base, rank, C);
  }
}

template <int ST>
cudaError_t launch(const Args& a, int C, cudaStream_t st) {
  constexpr int smem = Layout<ST>::SMEM;
  static_assert(smem <= 232448, "one block an SM");
  auto kernel = ce_bwd_wgmma<ST>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8)  // a cluster past the portable 8 blocks, on the current card
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  const int ndx = (a.N + TILE - 1) / TILE, ndw = (a.V + TILE - 1) / TILE;
  if (ndx + ndw > 65535) return cudaErrorInvalidValue;
  // a dx cluster walks V in steps of 64, a dw cluster N
  const int dx_first = (a.V + STEP - 1) / STEP >= (a.N + STEP - 1) / STEP;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, ndx + ndw);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, ndx, dx_first);
}

// The plan (C, 128, ST): C = ceil(D / 256) up to 16, ST 3 or 2 where the
// C blocks' partials fit Layout<ST>'s slots (_bwd_wgmma_plan takes 3 where
// it can); any other is refused, as is an operand TMA cannot read (D or
// ldw not a multiple of 8, a base off a 16-byte boundary) or a tensor map
// that cuTensorMapEncodeTiled refuses.
cudaError_t run(const bf16* x, const bf16* w, const void* b, const int* t, const float* lse,
                const float* g, bf16* dx, bf16* dw, void* db, int N, int D, int V, int ldw,
                int b_bf16, int C, int tile, int ST, cudaStream_t st) {
  if (N < 1 || D < 1 || V < 1 || C < 1 || C > MAX_C || C != (D + DS - 1) / DS || tile != TILE ||
      D % 8 || ldw % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  if (!(ST == 3 && bwd::slots_fit<STEP, STEP>(C, Layout<3>::SLOTS)) &&
      !(ST == 2 && bwd::slots_fit<STEP, STEP>(C, Layout<2>::SLOTS)))
    return cudaErrorInvalidValue;
  Args a;
  a.b = b;
  a.t = t;
  a.lse = lse;
  a.g = g;
  a.dx = dx;
  a.dw = dw;
  a.db = db;
  a.N = N, a.D = D, a.V = V, a.b_bf16 = b_bf16;
  const long long xd[4] = {D, N, 1, 1}, xs[3] = {2ll * D, 2ll * D * N, 2ll * D * N};
  // w: extent V, rows ldw apart; TMA fills the columns past V with zeros
  const long long wd[4] = {V, D, 1, 1}, ws[3] = {2ll * ldw, 2ll * ldw * D, 2ll * ldw * D};
  if (!encode_bf16_4d(&a.xmap, x, xd, xs, STEP) || !encode_bf16_4d(&a.wmap, w, wd, ws, DS))
    return cudaErrorInvalidValue;
  return ST == 3 ? launch<3>(a, C, st) : launch<2>(a, C, st);
}

}  // namespace bwg

template <int DW>
constexpr int bwd_smem() {
  return (DW + 3 * T32) * LD32 * 4;
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t st,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t fwd_f32(const Args<TB>& a, cudaStream_t st) {
  return launch(ce_fwd_f32<TB>, dim3((a.N + FBM - 1) / FBM), THREADS, 0, st, a);
}

template <typename TB>
cudaError_t bwd_f32(const Args<TB>& a, cudaStream_t st) {
  const int ndx = (a.N + T32 - 1) / T32, ndw = (a.V + T32 - 1) / T32;
  if (a.D <= 256)
    return launch(ce_bwd_f32<TB, 256>, dim3(ndx + ndw), THREADS, bwd_smem<256>(), st,
                  a, ndx);
  return launch(ce_bwd_f32<TB, 1024>, dim3(ndx + ndw), THREADS, bwd_smem<1024>(), st,
                a, ndx);
}

// The mma.sync forward over `splits` vocab splits of `per` tiles of 128
// (ops/fused_ce.py _fwd_plan).
template <typename TB>
cudaError_t fwd_mma(tc::Args<TB> a, int splits, int per, cudaStream_t st) {
  a.splits = splits;
  a.vchunk = per * tc::FV;
  const dim3 grid((a.N + tc::FM - 1) / tc::FM, splits);
  return launch(tc::ce_fwd_tc<TB>, grid, tc::TH, tc::fwd_smem, st, a);
}

// The wgmma forward over `splits` vocab splits of `per` tiles of 256; the
// tensor maps of x and w are encoded on every call (the pointers change),
// and one that cuTensorMapEncodeTiled refuses is refused here.
template <typename TB>
cudaError_t fwd_wgmma(const tc::Args<TB>& t, int splits, int per, cudaStream_t st) {
  wgf::Args<TB> a;
  a.b = t.b;
  a.t = t.t;
  a.loss = t.loss;
  a.lse_out = t.lse_out;
  a.part = t.part;
  a.count = t.count;
  a.N = t.N, a.D = t.D, a.V = t.V, a.splits = splits, a.per = per;
  const long long xd[4] = {t.D, t.N, 1, 1}, xs[3] = {2ll * t.D, 2ll * t.D * t.N, 2ll * t.D * t.N};
  // w: extent V, rows ldw apart; TMA fills the columns past V with zeros
  const long long wd[4] = {t.V, t.D, 1, 1},
                  ws[3] = {2ll * t.ldw, 2ll * t.ldw * t.D, 2ll * t.ldw * t.D};
  if (!dft::hopper::encode_bf16_4d(&a.maps.x, t.x, xd, xs, wgf::BM) ||
      !dft::hopper::encode_bf16_4d(&a.maps.w, t.w, wd, ws, wgf::BD))
    return cudaErrorInvalidValue;
  const dim3 grid((t.N + wgf::BM - 1) / wgf::BM, splits);
  return launch(wgf::ce_fwd_wgmma<TB>, grid, wgf::THREADS, wgf::SMEM, st, a);
}

template <typename TB>
cudaError_t fwd_bf16(const tc::Args<TB>& a, int route, int splits, int per, cudaStream_t st) {
  const int tile = route == 2 ? wgf::BV : tc::FV;
  const int most = route == 2 ? wgf::MAX_SPLITS : tc::MAX_SPLITS;
  const int nvt = (a.V + tile - 1) / tile;
  if (splits < 1 || splits > most || per < 1 || splits != (nvt + per - 1) / per)
    return cudaErrorInvalidValue;
  if (route == 2) {  // TMA reads rows of 16-byte multiples from 16-byte aligned bases
    if (a.D % 8 || a.ldw % 8 || reinterpret_cast<uintptr_t>(a.x) % 16 ||
        reinterpret_cast<uintptr_t>(a.w) % 16)
      return cudaErrorInvalidValue;
    return fwd_wgmma(a, splits, per, st);
  }
  return fwd_mma(a, splits, per, st);
}

template <typename TB>
Args<TB> f32_args(const void* x, const void* w, const void* b, const int* t,
                  const float* lse, const float* g, float* loss, float* lse_out, void* dx,
                  void* dw, void* db, int N, int D, int V, int ldw) {
  return Args<TB>{static_cast<const float*>(x), static_cast<const float*>(w),
                         static_cast<const TB*>(b), t, lse, g, loss, lse_out,
                         static_cast<float*>(dx), static_cast<float*>(dw), static_cast<TB*>(db),
                         N, D, V, ldw};
}

template <typename TB>
tc::Args<TB> bf16_args(const void* x, const void* w, const void* b, const int* t,
                       float* loss, float* lse_out, float* part, int* count, int N, int D,
                       int V, int ldw, int xvec) {
  using BF = __nv_bfloat16;
  return tc::Args<TB>{static_cast<const BF*>(x), static_cast<const BF*>(w),
                      static_cast<const TB*>(b), t, loss, lse_out, part, count,
                      N, D, V, ldw, 1, 0, xvec};
}

// bf16 w's rows must start 16-byte aligned: an ldw that is a multiple of 8
// and an aligned base (the bf16 kernels copy w 16 bytes at a time).
bool bf16_rows_aligned(const void* w, int ldw) {
  return ldw % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace

// x is (N, D) contiguous; w is (D, V) with rows ldw >= V elements apart,
// which in bf16 start 16-byte aligned (ops/fused_ce.py _staged pads a bf16
// w's rows to a multiple of 8 where they do not).  route (ops/fused_ce.py
// _fwd_route): 0 f32 x and w (the CUDA cores), 1 bf16 on mma.sync, 2 bf16
// on wgmma fed by TMA (D a multiple of 8, x's base aligned); b_bf16: b is
// bf16, else f32.  xvec: the rows of x start 16-byte aligned (the mma.sync
// kernel's 16-byte copies).  (splits, per): the bf16 kernels' vocab splits
// and the tiles a split (ops/fused_ce.py _fwd_plan); the f32 kernel takes
// (1, 1).  part (3 * 16 * N floats) and count (ceil(N / 128) ints, zero)
// are the bf16 kernels' scratch.  Returns the launch's cudaError_t (any
// other route, plan or w is refused with cudaErrorInvalidValue); the
// caller raises if it is not 0.
extern "C" int dft_flce_fwd(const void* x, const void* w, const void* b, const int* t,
                            float* loss, float* lse, float* part, int* count, int N, int D,
                            int V, int ldw, int route, int b_bf16, int xvec, int splits, int per,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (N < 1 || D < 1 || V < 1 || ldw < V) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if ((route == 1 || route == 2) && !bf16_rows_aligned(w, ldw))
    e = cudaErrorInvalidValue;
  else if (route == 1 || route == 2)
    e = b_bf16 ? fwd_bf16(bf16_args<BF>(x, w, b, t, loss, lse, part, count, N, D, V, ldw, xvec),
                          route, splits, per, s)
               : fwd_bf16(bf16_args<float>(x, w, b, t, loss, lse, part, count, N, D, V, ldw,
                                           xvec), route, splits, per, s);
  else if (route != 0 || splits != 1 || per != 1)
    e = cudaErrorInvalidValue;
  else
    e = b_bf16 ? fwd_f32(f32_args<BF>(x, w, b, t, 0, 0, loss, lse, 0, 0, 0, N, D, V, ldw), s)
               : fwd_f32(f32_args<float>(x, w, b, t, 0, 0, loss, lse, 0, 0, 0, N, D, V, ldw), s);
  return static_cast<int>(e);
}

// x and w as the forward takes them; dx, dw and db come out contiguous in
// x's, w's and b's dtypes (dw (D, V), rows V apart).  route
// (ops/fused_ce.py _bwd_route): 0 f32 x and w, D <= 1024, plan (0, 0, 0);
// 1 bf16 on the mma.sync clusters, plan (C, BM, BV) of _bwd_plan; 2 bf16 on
// the wgmma clusters fed by TMA (D a multiple of 8, x's base 16-byte
// aligned), plan (C, 128, ST) of _bwd_wgmma_plan.  Any other route, plan
// or w is refused with cudaErrorInvalidValue.
extern "C" int dft_flce_bwd(const void* x, const void* w, const void* b, const int* t,
                            const float* lse, const float* g, void* dx, void* dw, void* db,
                            int N, int D, int V, int ldw, int route, int b_bf16, int xvec,
                            int p0, int p1, int p2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t e;
  if (ldw < V || (route != 0 && !bf16_rows_aligned(w, ldw)))
    e = cudaErrorInvalidValue;
  else if (route == 2)
    e = bwg::run(static_cast<const BF*>(x), static_cast<const BF*>(w), b, t, lse, g,
                 static_cast<BF*>(dx), static_cast<BF*>(dw), db, N, D, V, ldw, b_bf16, p0, p1, p2,
                 s);
  else if (route == 1)
    e = bwd::run(bwd::Args{static_cast<const BF*>(x), static_cast<const BF*>(w), b, t, lse, g,
                           static_cast<BF*>(dx), static_cast<BF*>(dw), db, N, D, V, ldw, b_bf16,
                           xvec},
                 p0, p1, p2, s);
  else if (route != 0 || p0 != 0 || p1 != 0 || p2 != 0 || D < 1 || D > 1024)
    e = cudaErrorInvalidValue;
  else
    e = b_bf16 ? bwd_f32(f32_args<BF>(x, w, b, t, lse, g, 0, 0, dx, dw, db, N, D, V, ldw), s)
               : bwd_f32(f32_args<float>(x, w, b, t, lse, g, 0, 0, dx, dw, db, N, D, V, ldw), s);
  return static_cast<int>(e);
}
