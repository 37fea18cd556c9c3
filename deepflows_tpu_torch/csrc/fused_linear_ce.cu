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
// tensor-core rate) and the backward four times that (dx and dw each
// recompute the logits), each against 34 MB of operands, so both are bound
// by operations, and only tensor cores approach the bound.
//
// bf16 x and w take the tensor cores (mma.sync m16n8k16 fed by ldmatrix,
// mma_bf16.cuh).  Forward: a block of 8 warps owns 128 rows (16 a warp) and
// a share of the vocabulary; (x, w) chunks of 32 along D stream through a
// cp.async double buffer, and each row's max, sum-exp and target logit run
// online over vocab tiles of 128 as in the TPU kernel.  The vocabulary is
// split so that about two blocks run on each SM; the last split of a row
// block to finish (an atomic count) combines the splits' partials in a
// fixed order.  Backward: ONE launch of two block roles.  A dx block owns 32
// rows and their whole (32, D) dx in registers; per vocab tile of 64 it
// stages the (D, 64) slice of w, recomputes the logits tile from it and the
// block's x rows, and adds dl w^T.  A dw block owns 32 vocab columns and
// their whole (D, 32) dw and db, stages that slice of w once and streams x
// rows 32 at a time through a double buffer: the deterministic analogue of
// the TPU's (vocab tile, row tile) grid, with no atomics.  The backward takes
// D <= 1024 (the shared memory of one SM).
//
// f32 x and w run on the CUDA cores in f32 FMA: the same decomposition with
// 64 x 64 forward tiles and 32 x 32 backward tiles staged as f32.  Pipelined
// w slices, wgmma and TMA are later work; PERF.md holds the measured times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int N, D, V;
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
        ws[r][c] = (d0 + r < D && v0 + c < V) ? to_f(a.w[(long long)(d0 + r) * V + v0 + c]) : 0.f;
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
        if (col == tgt[i]) st[i] += lg;
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

// ws[d][c] = w[d][v0 + c] for d < DW (zero past D and V)
template <int DW>
__device__ __forceinline__ void stage_w(const float* w, int D, int V, int v0, float* ws) {
  for (int e = threadIdx.x; e < DW * T32; e += THREADS) {
    const int r = e / T32, c = e % T32;
    ws[r * LD32 + c] = (r < D && v0 + c < V) ? to_f(w[(long long)r * V + v0 + c]) : 0.f;
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
    stage_w<DW>(a.w, a.D, a.V, v0, ws);  // the previous tile ended synchronised
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
  stage_w<DW>(a.w, a.D, a.V, v0, ws);
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
// bf16 x and w on the tensor cores: mma.sync m16n8k16 fed by ldmatrix
namespace tc {

using namespace dft::mma;
constexpr int TH = 256;                        // 8 warps
constexpr int FM = 128, FV = 128, FD = 32;     // forward tiles: rows, vocab, D chunk
constexpr int FXL = FD + 8, FWL = FV + 8;      // their shared row strides
constexpr int MAX_SPLITS = 16;
constexpr int DW = 1024;                       // the largest D of the backward
constexpr int XL = DW + 8;                     // shared row stride of 32 x rows
constexpr int BV = 64, WL = BV + 8;            // dx role: vocab tile and its stride
constexpr int WL32 = 32 + 8;                   // dw role: 32 vocab columns

template <typename TB>
struct Args {
  const bf16 *x, *w;
  const TB* b;
  const int* t;
  const float *lse, *g;  // backward inputs
  float *loss, *lse_out;  // forward outputs
  float* part;           // forward: (m, l, target logit) per vocab split and row
  int* count;            // forward: finished splits per row block, zeroed by the caller
  bf16 *dx, *dw;
  TB* db;
  int N, D, V, splits, vchunk, xvec, wvec;
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
    stage_tile<FD, FV, TH>(xs + FM * FXL, FWL, a.w, a.V, d0, v0, a.D, vend, a.wvec);
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
          if (col == tgt[r]) st[r] += x;
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
  for (int r = threadIdx.x; r < FM; r += TH) {
    const int row = n0 + r;
    if (row >= a.N) continue;
    float mm = NEG_INF;
    for (int k = 0; k < a.splits; ++k)
      mm = fmaxf(mm, __ldcg(a.part + (long long)k * 3 * a.N + row));
    float ll = 0.f, ss = 0.f;
    for (int k = 0; k < a.splits; ++k) {
      const float* p = a.part + (long long)k * 3 * a.N;
      ll += __ldcg(p + a.N + row) * expf(__ldcg(p + row) - mm);
      ss += __ldcg(p + 2 * a.N + row);
    }
    const float lse = mm + logf(ll);
    a.lse_out[row] = lse;
    a.loss[row] = lse - ss;
  }
}

template <typename TB>
__device__ __forceinline__ float dlogit(const Args<TB>& a, int row, int col, float acc) {
  if (row >= a.N || col >= a.V) return 0.f;
  const float p = expf(acc + to_f(a.b[col]) - a.lse[row]);
  return (p - (col == a.t[row] ? 1.f : 0.f)) * a.g[row];
}

// dx of rows [n0, n0 + 32): warp w owns rows 16 (w & 1) .. + 15 and the
// 256 columns from 256 (w >> 1) of the (32, D) dx.  Per vocab tile of 64
// the (D, 64) slice of w is staged whole; the logits tile comes from it and
// the block's x rows, then dx += dl w^T.
template <typename TB>
__device__ __forceinline__ void dx_block(const Args<TB>& a, int n0, unsigned char* smem_raw) {
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [32][XL]
  bf16* ws = xs + 32 * XL;                        // [DW][WL]
  bf16* dls = ws + DW * WL;                       // [32][WL]
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int rw = (w & 1) * 16, cw = w >> 1;
  stage_tile<32, DW, TH>(xs, XL, a.x, a.D, n0, 0, a.N, a.D, a.xvec);
  float acc[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int v0 = 0; v0 < a.V; v0 += BV) {
    stage_tile<DW, BV, TH>(ws, WL, a.w, a.V, 0, v0, a.D, a.V, a.wvec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float lg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < a.D; kk += 16) {
      uint32_t af[4], bf[4];
      load_a(af, xs, XL, rw, kk);
      load_b_kn(bf, ws, WL, kk, cw * 16);
      mma(lg[0], af, bf[0], bf[1]);
      mma(lg[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rw + g + 8 * (i >> 1), c = cw * 16 + nt * 8 + 2 * t + (i & 1);
        dls[r * WL + c] = __float2bfloat16_rn(dlogit(a, n0 + r, v0 + c, lg[nt][i]));
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BV / 16; ++kk) {
      uint32_t af[4];
      load_a(af, dls, WL, rw, kk * 16);
#pragma unroll
      for (int np = 0; np < 16; ++np) {
        uint32_t bf[4];
        load_b_nk(bf, ws, WL, cw * 256 + np * 16, kk * 16);
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + rw + g + 8 * r;
    if (row >= a.N) continue;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int col = cw * 256 + n * 8 + 2 * t;
      if (col < a.D) a.dx[(long long)row * a.D + col] = __float2bfloat16_rn(acc[n][2 * r]);
      if (col + 1 < a.D)
        a.dx[(long long)row * a.D + col + 1] = __float2bfloat16_rn(acc[n][2 * r + 1]);
    }
  }
}

// dw and db of vocab columns [v0, v0 + 32): warp w owns dw rows 128 w ..
// + 127; threads 0..31 own db.  The (D, 32) slice of w is staged once; x
// rows stream through a double buffer, 32 at a time.
template <typename TB>
__device__ __forceinline__ void dw_block(const Args<TB>& a, int v0, unsigned char* smem_raw) {
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [DW][WL32]
  bf16* xb = ws + DW * WL32;                      // [2][32][XL]
  bf16* dls = xb + 2 * 32 * XL;                   // [32][WL32], in x's dtype
  float* dlf = reinterpret_cast<float*>(dls + 32 * WL32);  // [32][33], f32 for db
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int rw = (w & 1) * 16, cw = (w >> 1) * 8;
  const int nrt = (a.N + 31) / 32;
  stage_tile<DW, 32, TH>(ws, WL32, a.w, a.V, 0, v0, a.D, a.V, a.wvec);
  stage_tile<32, DW, TH>(xb, XL, a.x, a.D, 0, 0, a.N, a.D, a.xvec);
  cp_async_commit();
  float acc[8][4][4], dbacc = 0.f;
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  for (int rt = 0; rt < nrt; ++rt) {
    const int cur = rt & 1, n0 = rt * 32;
    if (rt + 1 < nrt)
      stage_tile<32, DW, TH>(xb + (cur ^ 1) * 32 * XL, XL, a.x, a.D, n0 + 32, 0, a.N, a.D,
                             a.xvec);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* xs = xb + cur * 32 * XL;
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < a.D; kk += 16) {
      uint32_t af[4], bf[4];
      load_a(af, xs, XL, rw, kk);
      load_b_kn(bf, ws, WL32, kk, cw);  // bf[2], bf[3]: the next 8 columns, unused
      mma(lg, af, bf[0], bf[1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rw + g + 8 * (i >> 1), c = cw + 2 * t + (i & 1);
      const float dl = dlogit(a, n0 + r, v0 + c, lg[i]);
      dls[r * WL32 + c] = __float2bfloat16_rn(dl);
      dlf[r * 33 + c] = dl;
    }
    __syncthreads();
    if (threadIdx.x < 32)
      for (int r = 0; r < 32; ++r) dbacc += dlf[r * 33 + threadIdx.x];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t b0[4], b1[4];
      load_b_kn(b0, dls, WL32, kk * 16, 0);
      load_b_kn(b1, dls, WL32, kk * 16, 16);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        uint32_t af[4];
        load_a_t(af, xs, XL, w * 128 + mt * 16, kk * 16);
        mma(acc[mt][0], af, b0[0], b0[1]);
        mma(acc[mt][1], af, b0[2], b0[3]);
        mma(acc[mt][2], af, b1[0], b1[1]);
        mma(acc[mt][3], af, b1[2], b1[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = w * 128 + mt * 16 + g + 8 * (i >> 1), col = v0 + n * 8 + 2 * t + (i & 1);
        if (d < a.D && col < a.V)
          a.dw[(long long)d * a.V + col] = __float2bfloat16_rn(acc[mt][n][i]);
      }
  if (threadIdx.x < 32 && v0 + threadIdx.x < a.V) a.db[v0 + threadIdx.x] = from_f<TB>(dbacc);
}

template <typename TB>
__global__ void __launch_bounds__(TH, 1) ce_bwd_tc(const __grid_constant__ Args<TB> a, int ndx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < ndx)
    dx_block<TB>(a, blockIdx.x * 32, smem_raw);
  else
    dw_block<TB>(a, (blockIdx.x - ndx) * 32, smem_raw);
}

constexpr int fwd_smem = 2 * (FM * FXL + FD * FWL) * 2;
// the larger of the dx role (32 x rows, a (DW, 64) slice of w, the dl tile)
// and the dw role (a (DW, 32) slice of w, two buffers of 32 x rows, dl in
// bf16 and f32)
constexpr int dx_smem = (32 * XL + DW * WL + 32 * WL) * 2;
constexpr int dw_smem = (DW * WL32 + 2 * 32 * XL + 32 * WL32) * 2 + 32 * 33 * 4;
constexpr int bwd_smem = dx_smem > dw_smem ? dx_smem : dw_smem;

}  // namespace tc

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

// Vocab splits of the forward: about two blocks an SM over the row blocks.
template <typename TB>
void split_vocab(tc::Args<TB>& a) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rb = (a.N + tc::FM - 1) / tc::FM, nvt = (a.V + tc::FV - 1) / tc::FV;
  int splits = (2 * sms + rb - 1) / rb;
  splits = splits < nvt ? splits : nvt;
  splits = splits < tc::MAX_SPLITS ? splits : tc::MAX_SPLITS;
  const int per = (nvt + splits - 1) / splits;  // vocab tiles a split
  a.vchunk = per * tc::FV;
  a.splits = (nvt + per - 1) / per;
}

template <typename TB>
cudaError_t fwd_bf16(tc::Args<TB> a, cudaStream_t st) {
  split_vocab(a);
  const dim3 grid((a.N + tc::FM - 1) / tc::FM, a.splits);
  return launch(tc::ce_fwd_tc<TB>, grid, tc::TH, tc::fwd_smem, st, a);
}

template <typename TB>
cudaError_t bwd_bf16(const tc::Args<TB>& a, cudaStream_t st) {
  const int ndx = (a.N + 31) / 32, ndw = (a.V + 31) / 32;
  return launch(tc::ce_bwd_tc<TB>, dim3(ndx + ndw), tc::TH, tc::bwd_smem, st, a, ndx);
}

template <typename TB>
Args<TB> f32_args(const void* x, const void* w, const void* b, const int* t,
                  const float* lse, const float* g, float* loss, float* lse_out, void* dx,
                  void* dw, void* db, int N, int D, int V) {
  return Args<TB>{static_cast<const float*>(x), static_cast<const float*>(w),
                         static_cast<const TB*>(b), t, lse, g, loss, lse_out,
                         static_cast<float*>(dx), static_cast<float*>(dw), static_cast<TB*>(db),
                         N, D, V};
}

template <typename TB>
tc::Args<TB> bf16_args(const void* x, const void* w, const void* b, const int* t,
                       const float* lse, const float* g, float* loss, float* lse_out,
                       float* part, int* count, void* dx, void* dw, void* db, int N, int D,
                       int V, int xvec, int wvec) {
  using BF = __nv_bfloat16;
  return tc::Args<TB>{static_cast<const BF*>(x), static_cast<const BF*>(w),
                      static_cast<const TB*>(b), t, lse, g, loss, lse_out, part, count,
                      static_cast<BF*>(dx), static_cast<BF*>(dw), static_cast<TB*>(db),
                      N, D, V, 1, 0, xvec, wvec};
}

}  // namespace

// x_bf16: x and w are bf16 (the tensor-core kernels), else f32 (the CUDA
// cores); b_bf16: b is bf16, else f32.  xvec / wvec: the rows of x / w
// start 16-byte aligned.  part (3 * 16 * N floats) and count (ceil(N / 128)
// ints, zero) are the bf16 forward's scratch.  Returns the launch's
// cudaError_t; the caller raises if it is not 0.
extern "C" int dft_flce_fwd(const void* x, const void* w, const void* b, const int* t,
                            float* loss, float* lse, float* part, int* count, int N, int D,
                            int V, int x_bf16, int b_bf16, int xvec, int wvec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t e;
  if (x_bf16)
    e = b_bf16 ? fwd_bf16(bf16_args<BF>(x, w, b, t, 0, 0, loss, lse, part, count, 0, 0, 0, N, D,
                                        V, xvec, wvec), s)
               : fwd_bf16(bf16_args<float>(x, w, b, t, 0, 0, loss, lse, part, count, 0, 0, 0, N,
                                           D, V, xvec, wvec), s);
  else
    e = b_bf16 ? fwd_f32(f32_args<BF>(x, w, b, t, 0, 0, loss, lse, 0, 0, 0, N, D, V), s)
               : fwd_f32(f32_args<float>(x, w, b, t, 0, 0, loss, lse, 0, 0, 0, N, D, V), s);
  return static_cast<int>(e);
}

// D <= 1024.  dx, dw and db come out in x's, w's and b's dtypes.
extern "C" int dft_flce_bwd(const void* x, const void* w, const void* b, const int* t,
                            const float* lse, const float* g, void* dx, void* dw, void* db,
                            int N, int D, int V, int x_bf16, int b_bf16, int xvec, int wvec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t e;
  if (x_bf16)
    e = b_bf16 ? bwd_bf16(bf16_args<BF>(x, w, b, t, lse, g, 0, 0, 0, 0, dx, dw, db, N, D, V,
                                        xvec, wvec), s)
               : bwd_bf16(bf16_args<float>(x, w, b, t, lse, g, 0, 0, 0, 0, dx, dw, db, N, D, V,
                                           xvec, wvec), s);
  else
    e = b_bf16 ? bwd_f32(f32_args<BF>(x, w, b, t, lse, g, 0, 0, dx, dw, db, N, D, V), s)
               : bwd_f32(f32_args<float>(x, w, b, t, lse, g, 0, 0, dx, dw, db, N, D, V), s);
  return static_cast<int>(e);
}
