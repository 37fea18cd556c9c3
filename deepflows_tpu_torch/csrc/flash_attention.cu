// flash_attention: softmax(q k^T * scale + mask) v, forward and backward.
//
// Replaces the TPU kernels of deepflows_tpu/ops/pallas_kernels.py
// flash_attention: _flash_fwd_kernel (forward), _flash_dq_kernel and
// _flash_dkv_kernel (backward), and the head-packed single-block kernels
// _flash_packed_fwd_kernel / _flash_packed_bwd_kernel, whose semantics these
// kernels cover at every length.  q (B, H, Lq, D), k and v (B, H, Lk, D) in
// f32 or bf16, D <= 128, each given by pointer and element strides of its
// B, H and L axes (D contiguous), so the transposed head views of
// MultiheadAttention need no copy.
//
// Semantics, as in the TPU kernels: scores s = (q . k) * scale accumulate in
// f32; masked positions are the padded key tail (kpos >= Lk) and, when
// causal, kpos > qpos (top-left: both counted from 0 even when Lq != Lk) and,
// with a window, kpos <= qpos - window.  A masked score takes -1e30 and a
// probability of exactly 0, so a row without any visible key gives output 0
// and lse -1e30.  P is rounded to v's dtype before the P.V product, dS to
// k's (q's) dtype before the dq (dk) product; every sum is f32.  The forward
// saves lse = m + log(l) in f32, (B*H, Lq); the backward computes delta =
// rowsum(dO * O) from dO and O first (flash_bwd_delta).
//
// What bounds it on an H100: at the training slice's shape (B 8, H 8,
// L 1024, D 128, causal, bf16) the forward does 17.2 GFLOP of products
// (17.4 us at the bf16 tensor-core rate) against 67 MB of operands (20 us
// at 3.35 TB/s); the backward 43 GFLOP against 135 MB.  So both sit near
// the ridge, and only tensor cores can approach either bound.
//
// The bf16 forward has two routes (ops/flash_attention.py _fwd_route).
// Where TMA can read q, k and v (D % 8 == 0, every B, H, L stride a
// positive multiple of 8 elements, 16-byte aligned bases) it runs
// flash_fwd_wgmma (namespace wg): a producer warpgroup issues TMA loads
// into an mbarrier ring and two consumer warpgroups of 64 query rows run
// wgmma, each reading a K and V tile from shared memory once, where the
// mma.sync kernel below reads it once per 16-row warp; the grid takes the
// longest causal rows first.  The bf16 backward has the same two routes
// (_bwd_route, which asks the same of q, k, v and dout): flash_bwd_wgmma
// (namespace wgb) on the forward's block shape, or the mma.sync kernel.
// Every other bf16 call (D 100, misaligned views) runs on mma.sync:
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from shared
// memory, FlashAttention-2 style.
// A block of 4 warps owns 64 query rows (16 a warp) and loops over key
// tiles of 64; K and V tiles are staged in shared memory as bf16 rows with
// 16 bytes of padding, so every ldmatrix phase hits 8 distinct bank groups;
// V, K, Q and dO serve as the "k-major" operand through ldmatrix.trans, so
// no transposed copy is staged.  The score tile stays in registers: its
// accumulator layout is the A operand's layout of the next product, so P
// (and dS) go from one mma to the next without shared memory, rounded to
// bf16 on the way as the TPU kernel rounds them.
//
// f32 operands run on the CUDA cores in f32 FMA (tensor cores would round
// them to TF32): tiles of 64 x 64 staged as f32 with an odd row stride
// (D + 1), each thread owning 4 rows x 4 columns of a score tile.
//
// Both paths skip whole key tiles above the causal diagonal or below the
// window's band.  The backward's main kernel is ONE launch of two block
// roles on every route, as the TPU's two kernels are: a dq block loops
// over key tiles for one query tile, a dk/dv block over query tiles for
// one key tile.  Each output tile has one owner, so the backward is
// deterministic and needs no atomics, as is the forward (one owner a row,
// a fixed order of sums).  Before it, on the same stream, flash_bwd_delta
// computes delta = rowsum(dO * O) in f32 in one pass over dO and O (the
// JAX wrapper's sum, which XLA fuses).  A persistent grid is later work;
// PERF.md holds the measured times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int PLD = BK + 1;  // row stride of the P / dS tiles
constexpr float NEG_INF = -1e30f;

struct View {  // element strides of the B, H and L axes; D is contiguous
  long long sb, sh, sl;
};

struct Shape {
  int B, H, Lq, Lk, D, causal, window;
  int vec;  // every row starts 16-byte aligned and D % 8 == 0: 16-byte loads
  float scale;
};

__device__ __forceinline__ bool masked(const Shape& sh, int qpos, int kpos) {
  if (kpos >= sh.Lk) return true;
  if (!sh.causal) return false;
  return kpos > qpos || (sh.window > 0 && kpos <= qpos - sh.window);
}

// Key tiles [begin, end) of TK keys that hold a visible key for some query
// in [q0, q0 + TQ): causal skips tiles above the diagonal, a window those
// below the band (the TPU kernels' `needed` predicate).
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void key_range(const Shape& sh, int q0, int& begin, int& end) {
  begin = 0;
  end = (sh.Lk + TK - 1) / TK;
  if (sh.causal) {
    const int last = (q0 + TQ - 1) / TK + 1;
    end = end < last ? end : last;
    if (sh.window > 0) {
      const int lo = q0 - sh.window + 1;  // first visible key of the tile's first row
      begin = lo > 0 ? lo / TK : 0;
    }
  }
}

// Query tiles [begin, end) of TQ queries that see some key in [k0, k0 + TK).
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void query_range(const Shape& sh, int k0, int& begin, int& end) {
  begin = 0;
  end = (sh.Lq + TQ - 1) / TQ;
  if (sh.causal) {
    begin = k0 / TQ;
    if (sh.window > 0) {
      const int last = (k0 + TK - 1 + sh.window - 1) / TQ + 1;
      end = end < last ? end : last;
    }
  }
}

// rows [row0, row0 + 64) of a (L, D) matrix into dst[64][DP + 1] as f32,
// zero beyond L and D
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src, long long sl, int row0, int L,
                                      int D) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < 64 * DP; e += THREADS) {
    const int r = e / DP, c = e % DP, gr = row0 + r;
    dst[r * LD + c] = (gr < L && c < D) ? src[(long long)gr * sl + c] : 0.f;
  }
}

__device__ __forceinline__ float group_max(float v) {  // over the 16 lanes of a row group
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct FwdArgs {
  Shape sh;
  const T *q, *k, *v;
  T* o;
  float* lse;
  View vq, vk, vv, vo;
};

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(const __grid_constant__ FwdArgs<float> a) {
  constexpr int LD = DP + 1, NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;          // [BQ][LD]
  float* ks = qs + BQ * LD;  // [BK][LD]
  float* vs = ks + BK * LD;  // [BK][LD]
  float* ps = vs + BK * LD;  // [BQ][PLD]
  const Shape sh = a.sh;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H, q0 = blockIdx.x * BQ;
  const float* q = a.q + b * a.vq.sb + h * a.vq.sh;
  const float* k = a.k + b * a.vk.sb + h * a.vk.sh;
  const float* v = a.v + b * a.vv.sb + h * a.vv.sh;

  stage<DP>(qs, q, a.vq.sl, q0, sh.Lq, sh.D);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int kt0, kt1;
  key_range(sh, q0, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<DP>(ks, k, a.vk.sl, k0, sh.Lk, sh.D);
    stage<DP>(vs, v, a.vv.sl, k0, sh.Lk, sh.D);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = qs[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = ks[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
      bool mk[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mk[j] = masked(sh, qpos, k0 + tc + 16 * j);
        s[i][j] = mk[j] ? NEG_INF : s[i][j] * sh.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mk[j] ? 0.f : expf(s[i][j] - m_new);
        ps[(tr * 4 + i) * PLD + tc + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the 16 lanes of one warp
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(tr * 4 + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float y = vs[kk * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], y, acc[i][c]);
      }
    }
  }
  float* o = a.o + b * a.vo.sb + h * a.vo.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= sh.Lq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col < sh.D) o[(long long)row * a.vo.sl + col] = acc[i][c] / ls;
    }
    if (tc == 0) a.lse[(long long)bh * sh.Lq + row] = m[i] + logf(ls);
  }
}

template <typename T>
struct BwdArgs {
  Shape sh;
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  T *dq, *dk, *dv;
  View vq, vk, vv, vdo, vdq, vdk, vdv;
};

// blockIdx.z == 0: dq of one query tile, over its key tiles
template <int DP>
__device__ __forceinline__ void dq_block(const BwdArgs<float>& a, float* smem) {
  constexpr int LD = DP + 1, NC = DP / 16;
  const Shape sh = a.sh;
  const int q0 = blockIdx.x * BQ;
  if (q0 >= sh.Lq) return;
  float* qs = smem;            // [BQ][LD]
  float* dos = qs + BQ * LD;   // [BQ][LD]
  float* ks = dos + BQ * LD;   // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* dss = vs + BK * LD;   // [BQ][PLD]
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const float* k = a.k + b * a.vk.sb + h * a.vk.sh;
  const float* v = a.v + b * a.vv.sb + h * a.vv.sh;
  stage<DP>(qs, a.q + b * a.vq.sb + h * a.vq.sh, a.vq.sl, q0, sh.Lq, sh.D);
  stage<DP>(dos, a.dout + b * a.vdo.sb + h * a.vdo.sh, a.vdo.sl, q0, sh.Lq, sh.D);
  float lse[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    lse[i] = row < sh.Lq ? a.lse[(long long)bh * sh.Lq + row] : 0.f;
    delta[i] = row < sh.Lq ? a.delta[(long long)bh * sh.Lq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int kt0, kt1;
  key_range(sh, q0, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<DP>(ks, k, a.vk.sl, k0, sh.Lk, sh.D);
    stage<DP>(vs, v, a.vv.sl, k0, sh.Lk, sh.D);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float x[4], g[4], y[4], z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = qs[(tr * 4 + i) * LD + d];
        g[i] = dos[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = ks[(tc + 16 * j) * LD + d];
        z[j] = vs[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(x[i], y[j], s[i][j]);
          dp[i][j] = fmaf(g[i], z[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            masked(sh, qpos, k0 + tc + 16 * j) ? 0.f : expf(s[i][j] * sh.scale - lse[i]);
        const float ds = p * (dp[i][j] - delta[i]) * sh.scale;
        dss[(tr * 4 + i) * PLD + tc + 16 * j] = ds;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(tr * 4 + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float y = ks[kk * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], y, acc[i][c]);
      }
    }
  }
  float* dq = a.dq + b * a.vdq.sb + h * a.vdq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= sh.Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col < sh.D) dq[(long long)row * a.vdq.sl + col] = acc[i][c];
    }
  }
}

// blockIdx.z == 1: dk and dv of one key tile, over its query tiles.  A
// thread owns 4 key rows x 4 query columns of the transposed score tile.
template <int DP>
__device__ __forceinline__ void dkv_block(const BwdArgs<float>& a, float* smem) {
  constexpr int LD = DP + 1, NC = DP / 16;
  const Shape sh = a.sh;
  const int k0 = blockIdx.x * BK;
  if (k0 >= sh.Lk) return;
  float* ks = smem;            // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* qs = vs + BK * LD;    // [BQ][LD]
  float* dos = qs + BQ * LD;   // [BQ][LD]
  float* pts = dos + BQ * LD;  // [BK][PLD]: P^T
  float* dst = pts + BK * PLD; // [BK][PLD]: dS^T
  float* lse_s = dst + BK * PLD;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const float* q = a.q + b * a.vq.sb + h * a.vq.sh;
  const float* dout = a.dout + b * a.vdo.sb + h * a.vdo.sh;
  stage<DP>(ks, a.k + b * a.vk.sb + h * a.vk.sh, a.vk.sl, k0, sh.Lk, sh.D);
  stage<DP>(vs, a.v + b * a.vv.sb + h * a.vv.sh, a.vv.sl, k0, sh.Lk, sh.D);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  int qt0, qt1;
  query_range(sh, k0, qt0, qt1);
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    stage<DP>(qs, q, a.vq.sl, q0, sh.Lq, sh.D);
    stage<DP>(dos, dout, a.vdo.sl, q0, sh.Lq, sh.D);
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < sh.Lq ? a.lse[(long long)bh * sh.Lq + row] : 0.f;
      delta_s[tid] = row < sh.Lq ? a.delta[(long long)bh * sh.Lq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float x[4], z[4], y[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = ks[(tr * 4 + i) * LD + d];
        z[i] = vs[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = qs[(tc + 16 * j) * LD + d];
        g[j] = dos[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(x[i], y[j], s[i][j]);
          dp[i][j] = fmaf(z[i], g[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tc + 16 * j, qpos = q0 + qj;
        const float p = (qpos >= sh.Lq || masked(sh, qpos, kpos))
                            ? 0.f
                            : expf(s[i][j] * sh.scale - lse_s[qj]);
        const float ds = p * (dp[i][j] - delta_s[qj]) * sh.scale;
        pts[(tr * 4 + i) * PLD + qj] = p;
        dst[(tr * 4 + i) * PLD + qj] = ds;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pts[(tr * 4 + i) * PLD + qq];
        ds[i] = dst[(tr * 4 + i) * PLD + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = dos[qq * LD + tc + 16 * c];
        const float x = qs[qq * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(p[i], g, dv[i][c]);
          dk[i][c] = fmaf(ds[i], x, dk[i][c]);
        }
      }
    }
  }
  float* dkp = a.dk + b * a.vdk.sb + h * a.vdk.sh;
  float* dvp = a.dv + b * a.vdv.sb + h * a.vdv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr * 4 + i;
    if (row >= sh.Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col < sh.D) {
        dkp[(long long)row * a.vdk.sl + col] = dk[i][c];
        dvp[(long long)row * a.vdv.sl + col] = dv[i][c];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_f32(const __grid_constant__ BwdArgs<float> a) {
  extern __shared__ float smem[];
  if (blockIdx.z == 0)
    dq_block<DP>(a, smem);
  else
    dkv_block<DP>(a, smem);
}

// ------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 fed by ldmatrix
namespace tc {

using namespace dft::mma;
constexpr int WARPS = 4, TC_THREADS = 32 * WARPS;

// rows [row0, row0 + 64) of a (L, D) bf16 matrix into dst[64][DP + 8]
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long sl, int row0, int L,
                                      int D, int vec) {
  stage_tile<64, DP, TC_THREADS>(dst, DP + 8, src, sl, row0, 0, L, D, vec);
}

// Whether any key of [k0, k0 + BK) is hidden from some query of
// [r0, r0 + 16): if not, a warp's score tile needs no mask.
__device__ __forceinline__ bool tile_masked(const Shape& sh, int r0, int k0) {
  if (k0 + BK > sh.Lk) return true;
  if (!sh.causal) return false;
  return k0 + BK - 1 > r0 || (sh.window > 0 && k0 <= r0 + 15 - sh.window);
}

// one accumulator pair (columns col, col + 1 of a row) to global memory
__device__ __forceinline__ void store2(bf16* row, int col, int D, float x, float y, int vec) {
  if (vec && col + 1 < D) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < D) row[col] = __float2bfloat16_rn(x);
    if (col + 1 < D) row[col + 1] = __float2bfloat16_rn(y);
  }
}

template <int DP>
constexpr int tile_bytes() {
  return 64 * (DP + 8) * 2;
}

// Forward: warp w owns query rows q0 + 16w .. + 15; lane (g = l / 4,
// t = l % 4) holds rows g and g + 8 and, of each 8-column n-tile, columns
// 2t and 2t + 1 (mma's accumulator layout).
template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
    flash_fwd_tc(const __grid_constant__ FwdArgs<bf16> a) {
  constexpr int LDS = DP + 8, ND = DP / 8, TILE = 64 * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LDS]
  bf16* kv = qs + TILE;                           // K, V of 2 buffers: [2][2][64][LDS]
  const Shape sh = a.sh;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H, q0 = blockIdx.x * BQ;
  const bf16* k = a.k + b * a.vk.sb + h * a.vk.sh;
  const bf16* v = a.v + b * a.vv.sb + h * a.vv.sh;
  int kt0, kt1;
  key_range(sh, q0, kt0, kt1);
  stage<DP>(qs, a.q + b * a.vq.sb + h * a.vq.sh, a.vq.sl, q0, sh.Lq, sh.D, sh.vec);
  if (kt0 < kt1) {
    stage<DP>(kv, k, a.vk.sl, kt0 * BK, sh.Lk, sh.D, sh.vec);
    stage<DP>(kv + TILE, v, a.vv.sl, kt0 * BK, sh.Lk, sh.D, sh.vec);
  }
  cp_async_commit();
  float o[ND][4], m[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK, cur = (kt - kt0) & 1;
    if (kt + 1 < kt1) {  // the next tile streams in while this one computes
      bf16* nxt = kv + (cur ^ 1) * 2 * TILE;
      stage<DP>(nxt, k, a.vk.sl, k0 + BK, sh.Lk, sh.D, sh.vec);
      stage<DP>(nxt + TILE, v, a.vv.sl, k0 + BK, sh.Lk, sh.D, sh.vec);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* ks = kv + cur * 2 * TILE;
    const bf16* vs = ks + TILE;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t af[4];
      load_a(af, qs, LDS, w * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        load_b_nk(bf, ks, LDS, np * 16, kk * 16);
        mma(s[2 * np], af, bf[0], bf[1]);
        mma(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    const bool mask = tile_masked(sh, q0 + w * 16, k0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + w * 16 + g + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * r + c];
          x = (mask && masked(sh, qpos, k0 + n * 8 + 2 * t + c)) ? NEG_INF : x * sh.scale;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * r + c];
          x = (mask && masked(sh, qpos, k0 + n * 8 + 2 * t + c)) ? 0.f : expf(x - m_new);
          rs += x;
        }
      lsum[r] = lsum[r] * alpha + quad_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }
    // O += P V: P (bf16, rounded as the TPU kernel rounds it) straight from
    // the score accumulators; V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bf[4];
        load_b_kn(bf, vs, LDS, kk * 16, dp * 16);
        mma(o[2 * dp], pa, bf[0], bf[1]);
        mma(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  bf16* out = a.o + b * a.vo.sb + h * a.vo.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    if (row >= sh.Lq) continue;
    const float ls = lsum[r] == 0.f ? 1.f : lsum[r];
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2(out + (long long)row * a.vo.sl, d * 8 + 2 * t, sh.D, o[d][2 * r] / ls,
             o[d][2 * r + 1] / ls, sh.vec);
    if (t == 0) a.lse[(long long)bh * sh.Lq + row] = m[r] + logf(ls);
  }
}

// dq of one query tile (blockIdx.z == 0)
template <int DP>
__device__ __forceinline__ void dq_block(const BwdArgs<bf16>& a, unsigned char* smem_raw) {
  constexpr int LDS = DP + 8, ND = DP / 8;
  const Shape sh = a.sh;
  const int q0 = blockIdx.x * BQ;
  if (q0 >= sh.Lq) return;
  constexpr int TILE = 64 * LDS;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TILE;
  bf16* kv = dos + TILE;  // K, V of 2 buffers: [2][2][64][LDS]
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const bf16* k = a.k + b * a.vk.sb + h * a.vk.sh;
  const bf16* v = a.v + b * a.vv.sb + h * a.vv.sh;
  int kt0, kt1;
  key_range(sh, q0, kt0, kt1);
  stage<DP>(qs, a.q + b * a.vq.sb + h * a.vq.sh, a.vq.sl, q0, sh.Lq, sh.D, sh.vec);
  stage<DP>(dos, a.dout + b * a.vdo.sb + h * a.vdo.sh, a.vdo.sl, q0, sh.Lq, sh.D, sh.vec);
  if (kt0 < kt1) {
    stage<DP>(kv, k, a.vk.sl, kt0 * BK, sh.Lk, sh.D, sh.vec);
    stage<DP>(kv + TILE, v, a.vv.sl, kt0 * BK, sh.Lk, sh.D, sh.vec);
  }
  cp_async_commit();
  float lse[2], delta[2], dq[ND][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    lse[r] = row < sh.Lq ? a.lse[(long long)bh * sh.Lq + row] : 0.f;
    delta[r] = row < sh.Lq ? a.delta[(long long)bh * sh.Lq + row] : 0.f;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK, cur = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      bf16* nxt = kv + (cur ^ 1) * 2 * TILE;
      stage<DP>(nxt, k, a.vk.sl, k0 + BK, sh.Lk, sh.D, sh.vec);
      stage<DP>(nxt + TILE, v, a.vv.sl, k0 + BK, sh.Lk, sh.D, sh.vec);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* ks = kv + cur * 2 * TILE;
    const bf16* vs = ks + TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ad[4];
      load_a(aq, qs, LDS, w * 16, kk * 16);
      load_a(ad, dos, LDS, w * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, ks, LDS, np * 16, kk * 16);
        load_b_nk(bv, vs, LDS, np * 16, kk * 16);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ad, bv[0], bv[1]);
        mma(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    const bool mask = tile_masked(sh, q0 + w * 16, k0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + w * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * r + c];
          const float p = (mask && masked(sh, qpos, k0 + n * 8 + 2 * t + c))
                              ? 0.f
                              : expf(x * sh.scale - lse[r]);
          x = p * (dp[n][2 * r + c] - delta[r]) * sh.scale;  // dS
        }
    }
    // dq += dS K: dS rounded to bf16 from the accumulators, K through .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      pack_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t bk[4];
        load_b_kn(bk, ks, LDS, kk * 16, d2 * 16);
        mma(dq[2 * d2], da, bk[0], bk[1]);
        mma(dq[2 * d2 + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  bf16* out = a.dq + b * a.vdq.sb + h * a.vdq.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    if (row >= sh.Lq) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2(out + (long long)row * a.vdq.sl, d * 8 + 2 * t, sh.D, dq[d][2 * r],
             dq[d][2 * r + 1], sh.vec);
  }
}

// dk and dv of one key tile (blockIdx.z == 1): warp w owns key rows
// k0 + 16w .. + 15 of the transposed score tile S^T = K Q^T, whose columns
// are the tile's 64 queries.
template <int DP>
__device__ __forceinline__ void dkv_block(const BwdArgs<bf16>& a, unsigned char* smem_raw) {
  constexpr int LDS = DP + 8, ND = DP / 8;
  const Shape sh = a.sh;
  const int k0 = blockIdx.x * BK;
  if (k0 >= sh.Lk) return;
  constexpr int TILE = 64 * LDS;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TILE;
  bf16* qd = vs + TILE;  // Q, dO of 2 buffers: [2][2][64][LDS]
  float* rows_s = reinterpret_cast<float*>(qd + 4 * TILE);  // lse, delta: [2][2][64]
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const bf16* q = a.q + b * a.vq.sb + h * a.vq.sh;
  const bf16* dout = a.dout + b * a.vdo.sb + h * a.vdo.sh;
  int qt0, qt1;
  query_range(sh, k0, qt0, qt1);
  // the q tile's rows of Q, dO, lse and delta into buffer `buf`
  auto fetch = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    stage<DP>(qd + buf * 2 * TILE, q, a.vq.sl, q0, sh.Lq, sh.D, sh.vec);
    stage<DP>(qd + buf * 2 * TILE + TILE, dout, a.vdo.sl, q0, sh.Lq, sh.D, sh.vec);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      float* rs = rows_s + buf * 2 * BQ;
      rs[threadIdx.x] = row < sh.Lq ? a.lse[(long long)bh * sh.Lq + row] : 0.f;
      rs[BQ + threadIdx.x] = row < sh.Lq ? a.delta[(long long)bh * sh.Lq + row] : 0.f;
    }
  };
  stage<DP>(ks, a.k + b * a.vk.sb + h * a.vk.sh, a.vk.sl, k0, sh.Lk, sh.D, sh.vec);
  stage<DP>(vs, a.v + b * a.vv.sb + h * a.vv.sh, a.vv.sl, k0, sh.Lk, sh.D, sh.vec);
  if (qt0 < qt1) fetch(qt0, 0);
  cp_async_commit();
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[d][c] = dv[d][c] = 0.f;
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BQ, cur = (qt - qt0) & 1;
    if (qt + 1 < qt1) fetch(qt + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* qs = qd + cur * 2 * TILE;
    const bf16* dos = qs + TILE;
    const float* lse_s = rows_s + cur * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4];
      load_a(ak, ks, LDS, w * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        load_b_nk(bq, qs, LDS, np * 16, kk * 16);
        mma(p[2 * np], ak, bq[0], bq[1]);
        mma(p[2 * np + 1], ak, bq[2], bq[3]);
      }
    }
    // no mask when every query of the tile sees every key of the warp's rows
    const bool mask = q0 + BQ > sh.Lq || k0 + w * 16 + 16 > sh.Lk ||
                      (sh.causal && (k0 + w * 16 + 15 > q0 ||
                                     (sh.window > 0 && k0 + w * 16 <= q0 + BQ - 1 - sh.window)));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = k0 + w * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qj = n * 8 + 2 * t + c, qpos = q0 + qj;
          float& x = p[n][2 * r + c];
          x = (mask && (qpos >= sh.Lq || masked(sh, qpos, kpos)))
                  ? 0.f
                  : expf(x * sh.scale - lse_s[qj]);
        }
    }
    // dv += P^T dO, with P^T rounded to bf16; dO through .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pack_a(pa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t bd[4];
        load_b_kn(bd, dos, LDS, kk * 16, d2 * 16);
        mma(dv[2 * d2], pa, bd[0], bd[1]);
        mma(dv[2 * d2 + 1], pa, bd[2], bd[3]);
      }
    }
    // dS^T = P^T (dP^T - delta) * scale, dP^T = V dO^T, 16 queries at a time
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t av[4], bd[4];
        load_a(av, vs, LDS, w * 16, kk * 16);
        load_b_nk(bd, dos, LDS, np * 16, kk * 16);
        mma(dpt[0], av, bd[0], bd[1]);
        mma(dpt[1], av, bd[2], bd[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qj = (2 * np + half) * 8 + 2 * t + (i & 1);
          float& x = p[2 * np + half][i];
          x = x * (dpt[half][i] - delta_s[qj]) * sh.scale;
        }
    }
    // dk += dS^T Q, with dS^T rounded to bf16; Q through .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      pack_a(da, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t bq[4];
        load_b_kn(bq, qs, LDS, kk * 16, d2 * 16);
        mma(dk[2 * d2], da, bq[0], bq[1]);
        mma(dk[2 * d2 + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  bf16* dkp = a.dk + b * a.vdk.sb + h * a.vdk.sh;
  bf16* dvp = a.dv + b * a.vdv.sb + h * a.vdv.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + w * 16 + g + 8 * r;
    if (row >= sh.Lk) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      store2(dkp + (long long)row * a.vdk.sl, d * 8 + 2 * t, sh.D, dk[d][2 * r],
             dk[d][2 * r + 1], sh.vec);
      store2(dvp + (long long)row * a.vdv.sl, d * 8 + 2 * t, sh.D, dv[d][2 * r],
             dv[d][2 * r + 1], sh.vec);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
    flash_bwd_tc(const __grid_constant__ BwdArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.z == 0)
    dq_block<DP>(a, smem_raw);
  else
    dkv_block<DP>(a, smem_raw);
}

}  // namespace tc

// ------------------------------------------------------------------
// bf16 forward on Hopper: wgmma fed from a TMA ring.  Warpgroup 0 is the
// producer: it gives most of its registers to the consumers, and one of
// its threads issues every TMA load (Q once, then K and V tile by tile into
// a ring of ST slots, each with a full and an empty mbarrier).  Warpgroups
// 1 and 2 are consumers of 64 query rows each (a block owns 128): S = Q K^T
// by wgmma from shared memory, the online softmax on S's accumulators, and
// O += P V by wgmma with P from registers and V read MN-major (transpose-B
// bit), so K and V are read from shared memory once per warpgroup and no
// transposed copy is staged.  Within a consumer, the product P V of one
// key tile runs on the tensor cores while the softmax of the next tile's
// scores runs on the other units; O is rescaled once that product is done.
namespace wg {

using namespace dft::hopper;
using dft::mma::bf16;
using dft::mma::pack;
using dft::mma::quad_max;
using dft::mma::quad_sum;

constexpr int BQW = 128;          // query rows a block: two consumer warpgroups of 64
// Key tiles of 128 and a ring of three slots: the fastest of key tiles of
// 64 or 128 and 2 or 3 slots at the training slice's shape (PERF.md,
// tools/flash_fwd_ab.py --check, which builds the others from copies of
// this line).
constexpr int BKT = 128, ST = 3;
constexpr int WG_THREADS = 384;   // the producer warpgroup and two consumers
// 128 x 40 + 256 x 232 registers = 64,512, what 384 threads of 168 hold at launch
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

struct Maps {  // TMA tensor maps of q, k and v, (D, L, H, B), boxes of 64 x rows
  CUtensorMap q, k, v;
};

struct Args {
  Maps maps;  // first: a CUtensorMap is 64-byte aligned in the parameter space
  FwdArgs<bf16> a;
  int group;  // heads whose blocks run together (heads_in_l2)
};

// Heads whose K and V fit in 32 MiB of the 50 MB L2: the grid runs the
// blocks of one group of heads before the next, so each K and V tile is
// read from device memory about once and then from L2 by every query tile
// of its head.
constexpr long long L2_KV_BYTES = 32ll << 20;
inline int heads_in_l2(const Shape& sh) {
  const long long per_head = 4ll * sh.Lk * sh.D;  // K and V, bf16
  const long long g = L2_KV_BYTES / per_head;
  const long long bh = (long long)sh.B * sh.H;
  return (int)(g < 1 ? 1 : g > bh ? bh : g);
}

// Shared memory: Q [DP / 64][BQW][64], then ST slots of K and ST of V, each
// [DP / 64][BKT][64], all 1024-byte aligned (the swizzle's period), then
// the barriers.
template <int DP>
struct Layout {
  static constexpr int Q_BYTES = BQW * DP * 2, KV_BYTES = BKT * DP * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + (1 + 4 * ST) * 8;
};

struct Ring {
  unsigned char *q, *k, *v;
  uint64_t *qbar, *kfull, *kempty, *vfull, *vempty;
};

template <int DP>
__device__ __forceinline__ void produce(const Args& args, const Ring& r, int q0, int kt0, int n,
                                        int h, int b) {
  using L = Layout<DP>;
  const CUtensorMap *mq = &args.maps.q, *mk = &args.maps.k, *mv = &args.maps.v;
  tma_prefetch_map(mq);
  tma_prefetch_map(mk);
  tma_prefetch_map(mv);
  mbar_expect_tx(r.qbar, L::Q_BYTES);
#pragma unroll
  for (int x = 0; x < DP / 64; ++x) tma_load_4d(r.q + x * BQW * 128, mq, r.qbar, 64 * x, q0, h, b);
  for (int i = 0; i < n; ++i) {
    const int s = i % ST, k0 = (kt0 + i) * BKT;
    const uint32_t ph = (i / ST) & 1;  // the slot's round; its first wait passes at once
    mbar_wait(r.kempty + s, ph ^ 1);
    mbar_expect_tx(r.kfull + s, L::KV_BYTES);
#pragma unroll
    for (int x = 0; x < DP / 64; ++x)
      tma_load_4d(r.k + s * L::KV_BYTES + x * BKT * 128, mk, r.kfull + s, 64 * x, k0, h, b);
    mbar_wait(r.vempty + s, ph ^ 1);
    mbar_expect_tx(r.vfull + s, L::KV_BYTES);
#pragma unroll
    for (int x = 0; x < DP / 64; ++x)
      tma_load_4d(r.v + s * L::KV_BYTES + x * BKT * 128, mv, r.vfull + s, 64 * x, k0, h, b);
  }
}

// 2^x in one MUFU.EX2: results below 2^-126 flush to 0, far below what
// the bf16 P and the f32 row sums resolve against their row maximum's 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile's scores s (raw q . k on entry,
// unrounded probabilities on exit), rows r0 + g and r0 + g + 8 of the
// warp.  Scores go to log2 units with the scale folded in; the mask is
// built only on tiles that need it and read once per element: a hidden key
// scores NEG_INF.  Probabilities are exp2(x - offset) with offset the
// row's running maximum, or 0 while the row has seen no key (its maximum
// is still NEG_INF), so a hidden key's probability is exactly 0 and
// exp2(NEG_INF - NEG_INF) never happens.  lsum is this lane's share of
// the row sum (alpha is the same on the row's four lanes).
__device__ __forceinline__ void softmax(float (&s)[BKT / 2], float (&m)[2], float (&lsum)[2],
                                        float (&alpha)[2], const Shape& sh, int k0, int r0,
                                        int g, int tq, float sl2) {
  const bool edge = k0 + BKT > sh.Lk ||
                    (sh.causal && (k0 + BKT - 1 > r0 ||
                                   (sh.window > 0 && k0 <= r0 + 15 - sh.window)));
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (edge) {
      // this lane's columns 8 j + cc see keys with lo < 8 j + cc <= hi
      const int qpos = r0 + g + 8 * hh;
      int hi = sh.Lk - 1, lo = -1;
      if (sh.causal) {
        hi = min(hi, qpos);
        if (sh.window > 0) lo = qpos - sh.window;
      }
      hi -= k0 + 2 * tq;
      lo -= k0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float& x = s[4 * j + 2 * hh + cc];
          x = (8 * j + cc > hi || 8 * j + cc <= lo) ? NEG_INF : x * sl2;
          mx[hh] = fmaxf(mx[hh], x);
        }
    } else {
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float& x = s[4 * j + 2 * hh + cc];
          x *= sl2;
          mx[hh] = fmaxf(mx[hh], x);
        }
    }
    mx[hh] = quad_max(mx[hh]);
    alpha[hh] = exp2_ftz(m[hh] - mx[hh]);
    const float off = mx[hh] == NEG_INF ? 0.f : mx[hh];
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float& x = s[4 * j + 2 * hh + cc];
        x = exp2_ftz(x - off);
        rs += x;
      }
    lsum[hh] = lsum[hh] * alpha[hh] + rs;
    m[hh] = mx[hh];
  }
}

// P (bf16, rounded as the TPU kernel rounds it) as the A operand of the
// P V product: K step kk takes accumulator n-blocks 2 kk and 2 kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&p)[BKT / 4], const float (&s)[BKT / 2]) {
#pragma unroll
  for (int i = 0; i < BKT / 4; ++i) p[i] = pack(s[2 * i], s[2 * i + 1]);
}

template <int DP>
__device__ __forceinline__ void consume(const Args& args, const Ring& r, int q0, int kt0, int n,
                                        int bh, int h, int b) {
  using L = Layout<DP>;
  const Shape& sh = args.a.sh;
  const int c = threadIdx.x / 128 - 1, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = q0 + 64 * c + 16 * w;  // the warp's first query row
  const float sl2 = sh.scale * LOG2E;
  float o[DP / 2], s[BKT / 2], m[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[BKT / 4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKT / 2; ++i) s[i] = 0.f;
  if (n > 0) {
    const uint64_t dq = desc_b128(r.q + c * 64 * 128, 16, 1024);
    const uint64_t dk = desc_b128(r.k, 16, 1024);
    const uint64_t dv = desc_b128(r.v, BKT * 128, 1024);
    auto scores = [&](int slot) {  // S = Q K^T on K slot `slot`
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BKT, 0>(s, dq + (((kk / 4) * BQW * 128 + (kk % 4) * 32) >> 4),
                         dk + ((slot * L::KV_BYTES + (kk / 4) * BKT * 128 + (kk % 4) * 32) >> 4),
                         kk);
      wgmma_commit();
    };
    auto values = [&](int slot) {  // O += P V on V slot `slot`
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_rs<DP, 1>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                        dv + ((slot * L::KV_BYTES + kk * 16 * 128) >> 4), 1);
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {  // this warp's reads of the slot are done
      if (lane == 0) mbar_arrive(bar);
    };
    mbar_wait(r.qbar, 0);
    mbar_wait(r.kfull, 0);
    fence_regs(s);
    wgmma_fence();
    scores(0);
    wgmma_wait<0>();
    fence_regs(s);
    release(r.kempty);
    softmax(s, m, lsum, alpha, sh, kt0 * BKT, r0, g, tq, sl2);
    pack_p(p, s);
    // The loop's body has no branch on the consumer: ptxas serialises every
    // wgmma of a path that diverges around one.
    for (int i = 1; i < n; ++i) {
      const int cur = i % ST, prv = (i - 1) % ST;
      mbar_wait(r.kfull + cur, (i / ST) & 1);
      fence_regs(s);  // the last tile's P, rescaled O and read S are written
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      scores(cur);
      mbar_wait(r.vfull + prv, ((i - 1) / ST) & 1);
      values(prv);
      wgmma_wait<1>();  // the scores are in; P V of the last tile runs on
      fence_regs(s);
      release(r.kempty + cur);
      softmax(s, m, lsum, alpha, sh, (kt0 + i) * BKT, r0, g, tq, sl2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(r.vempty + prv);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack_p(p, s);
    }
    const int last = (n - 1) % ST;
    mbar_wait(r.vfull + last, ((n - 1) / ST) & 1);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    values(last);
    wgmma_wait<0>();
    fence_regs(o);
  }
  // O / l to bf16 in the (B, Lq, H, D) output; lse = m ln 2 + log l, or
  // NEG_INF for a row that saw no key (its output is 0)
  float l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(lsum[hh]);
  bf16* out = args.a.o + b * args.a.vo.sb + h * args.a.vo.sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + g + 8 * hh;
    if (row >= sh.Lq) continue;
    const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];
    bf16* orow = out + (long long)row * args.a.vo.sl;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < sh.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
    if (tq == 0)
      args.a.lse[(long long)bh * sh.Lq + row] =
          l[hh] == 0.f ? NEG_INF : m[hh] * LN2 + logf(l[hh]);
  }
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ Args args) {
  using L = Layout<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  Ring r;
  r.q = smem_raw + (((raw + 1023) & ~1023u) - raw);
  r.k = r.q + L::Q_BYTES;
  r.v = r.k + ST * L::KV_BYTES;
  r.qbar = reinterpret_cast<uint64_t*>(r.v + ST * L::KV_BYTES);
  r.kfull = r.qbar + 1;
  r.kempty = r.kfull + ST;
  r.vfull = r.kempty + ST;
  r.vempty = r.vfull + ST;
  const Shape& sh = args.a.sh;
  // One block a (head, query tile); the heads in groups of args.group,
  // and within a group the longest causal rows first: its first blocks
  // take the last query tile of each of its heads.
  const int nq = (sh.Lq + BQW - 1) / BQW, per = args.group * nq;
  const int grp = blockIdx.x / per, idx = blockIdx.x % per;
  const int size = min(args.group, sh.B * sh.H - grp * args.group);  // the last may be smaller
  const int q0 = (nq - 1 - idx / size) * BQW;
  const int bh = grp * args.group + idx % size, b = bh / sh.H, h = bh % sh.H;
  int kt0, kt1;
  key_range<BQW, BKT>(sh, q0, kt0, kt1);
  const int n = kt1 > kt0 ? kt1 - kt0 : 0;
  if (threadIdx.x == 0) {
    mbar_init(r.qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(r.kfull + s, 1);
      mbar_init(r.vfull + s, 1);
      mbar_init(r.kempty + s, 8);  // one arrival from each consumer warp
      mbar_init(r.vempty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n > 0) produce<DP>(args, r, q0, kt0, n, h, b);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<DP>(args, r, q0, kt0, n, bh, h, b);
  }
}

}  // namespace wg

// ------------------------------------------------------------------
// bf16 backward on Hopper: wgmma fed from a TMA ring, on the forward's
// block shape (warpgroup 0 the producer, whose one thread issues every TMA
// load; warpgroups 1 and 2 consumers of 64 rows each), with two block
// roles in one launch and each output row with one owner:
//
// - dK/dV, one block a (head, key tile of 128): K and V are loaded once;
//   tiles of BQT queries of Q and dO, with their lse and delta (copied by
//   the delta pass into rows padded to a multiple of 128, so each slot's
//   share is one aligned bulk copy), stream through a ring of BST slots (a
//   full and an empty mbarrier each).  A consumer owns 64 key rows:
//   S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory (both
//   operands K-major, issued back to back),
//   P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - delta)
//   scale on the accumulators, lse and delta taken by column from the slot;
//   then dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16
//   (where the TPU kernel rounds them) and packed into A registers, and dO
//   and Q read MN-major (transpose-B bit) from the same shared tiles, so no
//   transposed copy is staged.  dK and dV stay in registers until the end.
// - dQ, one block a (head, query tile of 128): Q and dO are loaded once,
//   each thread keeps its rows' lse and delta in registers, and tiles of
//   KT keys of K and V stream through the ring: S = Q K^T, dP = dO V^T, dS
//   as above, dQ += dS K with K read MN-major.
//
// Both roles recompute S and dP (7 products a tile pair against the 5 the
// function needs), as the TPU's two kernels do; in exchange no output
// needs atomics and two calls give the same bits.  A hidden score's
// probability is selected to exactly 0, so exp2 of a hidden score against
// a row's lse of -1e30 never reaches the products.  The grid runs the
// longest causal blocks of both roles first (the dK/dV blocks of the first
// key tiles, the dQ blocks of the last query tiles), in groups of heads
// whose Q, dO, K and V fit in L2.
namespace wgb {

using namespace dft::hopper;
using dft::mma::bf16;
using dft::mma::pack;
using wg::exp2_ftz;
using wg::LOG2E;

constexpr int RES = 128;  // rows of a block's resident tiles: two consumers of 64
constexpr int KT = 64;    // keys of the dQ role's streamed tiles
// Queries of the dK/dV role's streamed tiles, and the ring's slots: the
// fastest of (64, 3), (64, 2) and (128, 2), the last of which spills at D
// 128 (PERF.md; tools/flash_bwd_ab.py --check builds the others from copies
// of this line)
constexpr int BQT = 64, BST = 3;
constexpr int WG_THREADS = 384;  // the producer warpgroup and two consumers
// 128 x 24 + 256 x 240 registers = 64,512, what 384 threads of 168 hold at
// launch: the dK/dV consumers hold dK, dV, S^T and dP^T (192 f32 at D 128)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

struct Maps {  // q, k, v and dout (D, L, H, B) in boxes of 64 x 64
  CUtensorMap q, k, v, dout;
};

// a.lse is lse log2e and a.delta delta, each (B H, ld) with ld a multiple of
// 128 and zeros past Lq: the delta pass's copies
struct Args {
  Maps maps;  // first: a CUtensorMap is 64-byte aligned in the parameter space
  BwdArgs<bf16> a;
  int group;  // heads whose blocks run together (heads_in_l2)
  int ld;
};

// Heads whose Q, dO, K and V fit in 32 MiB of the 50 MB L2 (wg::heads_in_l2)
inline int heads_in_l2(const Shape& sh) {
  const long long per_head = 4ll * (sh.Lq + sh.Lk) * sh.D;  // bf16
  const long long g = wg::L2_KV_BYTES / per_head;
  const long long bh = (long long)sh.B * sh.H;
  return (int)(g < 1 ? 1 : g > bh ? bh : g);
}

// Shared memory: the two resident tiles [DP / 64][RES][64], then BST slots
// of two streamed tiles [DP / 64][rows][64] each, all 1024-byte aligned
// (the swizzle's period), then each slot's lse and delta [2][BQT], then
// the barriers.
template <int DP>
struct Layout {
  static constexpr int RES_BYTES = RES * DP * 2;
  static constexpr int TILE_BYTES = (BQT > KT ? BQT : KT) * DP * 2;
  static constexpr int SMEM =
      1024 + 2 * RES_BYTES + BST * (2 * TILE_BYTES + 2 * BQT * 4) + (1 + 2 * BST) * 8;
};

struct Ring {
  unsigned char *res, *tiles;  // slot s's tiles at tiles + 2 s TILE_BYTES
  float* rows;                 // slot s's lse at rows + 2 s BQT, its delta BQT on
  uint64_t *resbar, *full, *empty;
};

// One thread's loads: the resident pair (rows row0 .. + 127), then the
// streamed pairs of tiles t0 .. t0 + n - 1 (with lse and delta in the dK/dV
// role) as the ring's slots free up.
template <int DP>
__device__ __forceinline__ void produce(const Args& args, const Ring& r, bool dq, int row0,
                                        int t0, int n, int bh, int h, int b) {
  using L = Layout<DP>;
  const Maps& m = args.maps;
  const CUtensorMap *r0 = dq ? &m.q : &m.k, *r1 = dq ? &m.dout : &m.v;
  const CUtensorMap *s0 = dq ? &m.k : &m.q, *s1 = dq ? &m.v : &m.dout;
  tma_prefetch_map(r0);
  tma_prefetch_map(r1);
  tma_prefetch_map(s0);
  tma_prefetch_map(s1);
  mbar_expect_tx(r.resbar, 2 * L::RES_BYTES);
#pragma unroll
  for (int x = 0; x < DP / 64; ++x)
#pragma unroll
    for (int half = 0; half < RES / 64; ++half) {
      const int off = x * RES * 128 + half * 64 * 128;
      tma_load_4d(r.res + off, r0, r.resbar, 64 * x, row0 + 64 * half, h, b);
      tma_load_4d(r.res + L::RES_BYTES + off, r1, r.resbar, 64 * x, row0 + 64 * half, h, b);
    }
  const int rows = dq ? KT : BQT;
  const uint32_t bytes = 2 * rows * DP * 2 + (dq ? 0 : 2 * rows * 4);
  const long long base = (long long)bh * args.ld;
  for (int i = 0; i < n; ++i) {
    const int s = i % BST, row = (t0 + i) * rows;
    const uint32_t ph = (i / BST) & 1;  // the slot's round; its first wait passes at once
    mbar_wait(r.empty + s, ph ^ 1);
    mbar_expect_tx(r.full + s, bytes);
    unsigned char* t = r.tiles + s * 2 * L::TILE_BYTES;
    for (int half = 0; half < rows / 64; ++half) {
#pragma unroll
      for (int x = 0; x < DP / 64; ++x) {
        const int off = x * rows * 128 + half * 64 * 128;
        tma_load_4d(t + off, s0, r.full + s, 64 * x, row + 64 * half, h, b);
        tma_load_4d(t + L::TILE_BYTES + off, s1, r.full + s, 64 * x, row + 64 * half, h, b);
      }
      if (!dq) {
        float* rs = r.rows + s * 2 * BQT + 64 * half;
        bulk_load(rs, args.a.lse + base + row + 64 * half, 256, r.full + s);
        bulk_load(rs + BQT, args.a.delta + base + row + 64 * half, 256, r.full + s);
      }
    }
  }
}

// P = exp2(x sl2 - lse2) and dS = P (dp - delta) scale, in place (P into
// x, dS into dp), on a 64 x N accumulator tile of a warp, lse2 = lse log2e.
// In the dK/dV role rows are keys and columns queries, so lse2 and delta
// are taken by column from the slot; in the dQ role (given) by row.
// With MASK, this lane's columns 8 j + cc of row half hh are visible when
// lo[hh] < 8 j + cc <= hi[hh]; a hidden score's probability is 0.
template <bool MASK, bool BY_COL, int N>
__device__ __forceinline__ void grads(float (&x)[N / 2], float (&dp)[N / 2], const float* lse_s,
                                      const float* delta_s, const float (&lse2)[2],
                                      const float (&delta)[2], const int (&lo)[2],
                                      const int (&hi)[2], int tq, float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float2 lc = make_float2(0.f, 0.f), dc = lc;
    if constexpr (BY_COL) {
      lc = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tq);
      dc = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * tq);
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh + cc;
        const float l2 = BY_COL ? (cc ? lc.y : lc.x) : lse2[hh];
        const float de = BY_COL ? (cc ? dc.y : dc.x) : delta[hh];
        const bool hide = MASK && (8 * j + cc > hi[hh] || 8 * j + cc <= lo[hh]);
        const float p = hide ? 0.f : exp2_ftz(x[i] * sl2 - l2);
        x[i] = p;
        dp[i] = p * (dp[i] - de) * scale;
      }
  }
}

// accumulator pairs n-blocks 2 kk and 2 kk + 1 as the A operand of K step kk
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 4], const float (&x)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) a[i] = pack(x[2 * i], x[2 * i + 1]);
}

// rows row0 + g and row0 + g + 8 of a 64 x DP accumulator to bf16, masked
// by row < L and column < D
template <int DP>
__device__ __forceinline__ void store(bf16* base, long long sl, const float (&acc)[DP / 2],
                                      int row0, int g, int tq, int L, int D) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + 8 * hh;
    if (row >= L) continue;
    bf16* p = base + (long long)row * sl;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(p + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// The dK/dV role's consumer: key rows k0 + 64 c .. + 63, query tiles
// t0 .. t0 + n - 1 of BQT.
template <int DP>
__device__ __forceinline__ void consume_dkv(const Args& args, const Ring& r, int k0, int t0,
                                            int n, int h, int b) {
  using L = Layout<DP>;
  const Shape& sh = args.a.sh;
  const int c = threadIdx.x / 128 - 1, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kr = k0 + 64 * c + 16 * w;  // the warp's first key row
  const float sl2 = sh.scale * LOG2E;
  const float none[2] = {0.f, 0.f};
  float dk[DP / 2], dv[DP / 2], st[BQT / 2], dpt[BQT / 2];
  uint32_t pa[BQT / 4], da[BQT / 4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQT / 2; ++i) st[i] = dpt[i] = 0.f;
  if (n > 0) {
    const uint64_t ak = desc_b128(r.res + c * 64 * 128, 16, 1024);
    const uint64_t av = desc_b128(r.res + L::RES_BYTES + c * 64 * 128, 16, 1024);
    const uint64_t bq = desc_b128(r.tiles, 16, 1024);  // Q and dO K-major ...
    const uint64_t bdo = desc_b128(r.tiles + L::TILE_BYTES, 16, 1024);
    const uint64_t mq = desc_b128(r.tiles, BQT * 128, 1024);  // ... and MN-major
    const uint64_t mdo = desc_b128(r.tiles + L::TILE_BYTES, BQT * 128, 1024);
    auto scores = [&](int slot) {  // S^T = K Q^T and dP^T = V dO^T on slot `slot`
      const int so = slot * 2 * L::TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BQT, 0>(st, ak + (((kk / 4) * RES * 128 + (kk % 4) * 32) >> 4),
                         bq + ((so + (kk / 4) * BQT * 128 + (kk % 4) * 32) >> 4), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BQT, 0>(dpt, av + (((kk / 4) * RES * 128 + (kk % 4) * 32) >> 4),
                         bdo + ((so + (kk / 4) * BQT * 128 + (kk % 4) * 32) >> 4), kk);
      wgmma_commit();
    };
    auto products = [&](int slot) {  // dV += P^T dO and dK += dS^T Q on slot `slot`
      const int so = slot * 2 * L::TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs<DP, 1>(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                        mdo + ((so + kk * 16 * 128) >> 4), 1);
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs<DP, 1>(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                        mq + ((so + kk * 16 * 128) >> 4), 1);
      wgmma_commit();
    };
    auto dscores = [&](int slot, int q0) {  // P^T into st and dS^T into dpt, in place
      const float* ls = r.rows + slot * 2 * BQT;
      // no mask when every query of the tile sees every key of the warp's rows
      const bool edge = q0 + BQT > sh.Lq || kr + 16 > sh.Lk ||
                        (sh.causal && (kr + 15 > q0 ||
                                       (sh.window > 0 && kr <= q0 + BQT - 1 - sh.window)));
      if (edge) {
        // key kpos sees queries kpos <= qpos < kpos + window, qpos < Lq
        int lo[2], hi[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kpos = kr + g + 8 * hh;
          int l = -1, u = sh.Lq - 1;
          if (kpos >= sh.Lk) u = -1;
          if (sh.causal) {
            l = max(l, kpos - 1);
            if (sh.window > 0) u = min(u, kpos + sh.window - 1);
          }
          lo[hh] = l - q0 - 2 * tq;
          hi[hh] = u - q0 - 2 * tq;
        }
        grads<true, true, BQT>(st, dpt, ls, ls + BQT, none, none, lo, hi, tq, sl2, sh.scale);
      } else {
        const int all[2] = {-(1 << 30), -(1 << 30)}, any[2] = {1 << 30, 1 << 30};
        grads<false, true, BQT>(st, dpt, ls, ls + BQT, none, none, all, any, tq, sl2, sh.scale);
      }
    };
    auto release = [&](int slot) {  // this warp's reads of the slot are done
      if (lane == 0) mbar_arrive(r.empty + slot);
    };
    mbar_wait(r.resbar, 0);
    // One tile at a time: a tile's scores beside the last tile's products
    // would hold P^T and dS^T (32 registers) over the scores' 64 beside dK
    // and dV's 128, past the 240 a consumer has at D 128.
    for (int i = 0; i < n; ++i) {
      const int cur = i % BST;
      mbar_wait(r.full + cur, (i / BST) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      scores(cur);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      dscores(cur, (t0 + i) * BQT);
      pack_a<BQT>(pa, st);
      pack_a<BQT>(da, dpt);
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      products(cur);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      release(cur);
    }
  }
  const BwdArgs<bf16>& a = args.a;
  store<DP>(a.dk + b * a.vdk.sb + h * a.vdk.sh, a.vdk.sl, dk, kr, g, tq, sh.Lk, sh.D);
  store<DP>(a.dv + b * a.vdv.sb + h * a.vdv.sh, a.vdv.sl, dv, kr, g, tq, sh.Lk, sh.D);
}

// The dQ role's consumer: query rows q0 + 64 c .. + 63, key tiles t0 ..
// t0 + n - 1 of KT.
template <int DP>
__device__ __forceinline__ void consume_dq(const Args& args, const Ring& r, int q0, int t0,
                                           int n, int bh, int h, int b) {
  using L = Layout<DP>;
  const Shape& sh = args.a.sh;
  const BwdArgs<bf16>& a = args.a;
  const int c = threadIdx.x / 128 - 1, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = q0 + 64 * c + 16 * w;  // the warp's first query row
  const float sl2 = sh.scale * LOG2E;
  float lse2[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + g + 8 * hh;
    lse2[hh] = row < sh.Lq ? a.lse[(long long)bh * args.ld + row] : 0.f;
    delta[hh] = row < sh.Lq ? a.delta[(long long)bh * args.ld + row] : 0.f;
  }
  float dq[DP / 2], s[KT / 2], dp[KT / 2];
  uint32_t da[KT / 4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
  if (n > 0) {
    const uint64_t aq = desc_b128(r.res + c * 64 * 128, 16, 1024);
    const uint64_t ado = desc_b128(r.res + L::RES_BYTES + c * 64 * 128, 16, 1024);
    const uint64_t bk = desc_b128(r.tiles, 16, 1024);  // K and V K-major ...
    const uint64_t bv = desc_b128(r.tiles + L::TILE_BYTES, 16, 1024);
    const uint64_t mk = desc_b128(r.tiles, KT * 128, 1024);  // ... and K MN-major
    auto scores = [&](int slot) {  // S = Q K^T and dP = dO V^T on slot `slot`
      const int so = slot * 2 * L::TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<KT, 0>(s, aq + (((kk / 4) * RES * 128 + (kk % 4) * 32) >> 4),
                        bk + ((so + (kk / 4) * KT * 128 + (kk % 4) * 32) >> 4), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<KT, 0>(dp, ado + (((kk / 4) * RES * 128 + (kk % 4) * 32) >> 4),
                        bv + ((so + (kk / 4) * KT * 128 + (kk % 4) * 32) >> 4), kk);
      wgmma_commit();
    };
    auto product = [&](int slot) {  // dQ += dS K on slot `slot`
      const int so = slot * 2 * L::TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs<DP, 1>(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                        mk + ((so + kk * 16 * 128) >> 4), 1);
      wgmma_commit();
    };
    auto dscores = [&](int k0) {  // P and dS of key tile k0 in place, dS into dp
      const bool edge = k0 + KT > sh.Lk ||
                        (sh.causal && (k0 + KT - 1 > r0 ||
                                       (sh.window > 0 && k0 <= r0 + 15 - sh.window)));
      if (edge) {
        // query qpos sees keys qpos - window < kpos <= qpos, kpos < Lk
        int lo[2], hi[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qpos = r0 + g + 8 * hh;
          int l = -1, u = sh.Lk - 1;
          if (sh.causal) {
            u = min(u, qpos);
            if (sh.window > 0) l = qpos - sh.window;
          }
          lo[hh] = l - k0 - 2 * tq;
          hi[hh] = u - k0 - 2 * tq;
        }
        grads<true, false, KT>(s, dp, nullptr, nullptr, lse2, delta, lo, hi, tq, sl2, sh.scale);
      } else {
        const int all[2] = {-(1 << 30), -(1 << 30)}, any[2] = {1 << 30, 1 << 30};
        grads<false, false, KT>(s, dp, nullptr, nullptr, lse2, delta, all, any, tq, sl2,
                                sh.scale);
      }
    };
    auto release = [&](int slot) {  // this warp's reads of the slot are done
      if (lane == 0) mbar_arrive(r.empty + slot);
    };
    mbar_wait(r.resbar, 0);
    mbar_wait(r.full, 0);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    scores(0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dscores(t0 * KT);
    pack_a<KT>(da, dp);
    // Tile i's scores run on the tensor cores beside tile i - 1's dQ
    // product, then its dS beside that product; no branch on the consumer.
    for (int i = 1; i < n; ++i) {
      const int cur = i % BST, prv = (i - 1) % BST;
      mbar_wait(r.full + cur, (i / BST) & 1);
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq);
      fence_regs(da);
      wgmma_fence();
      scores(cur);
      product(prv);
      wgmma_wait<1>();  // the scores are in; the product runs on
      fence_regs(s);
      fence_regs(dp);
      dscores((t0 + i) * KT);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      release(prv);
      pack_a<KT>(da, dp);
    }
    const int last = (n - 1) % BST;
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
    product(last);
    wgmma_wait<0>();
    fence_regs(dq);
    release(last);
  }
  store<DP>(a.dq + b * a.vdq.sb + h * a.vdq.sh, a.vdq.sl, dq, r0, g, tq, sh.Lq, sh.D);
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ Args args) {
  using L = Layout<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  Ring r;
  r.res = smem_raw + (((raw + 1023) & ~1023u) - raw);
  r.tiles = r.res + 2 * L::RES_BYTES;
  r.rows = reinterpret_cast<float*>(r.tiles + BST * 2 * L::TILE_BYTES);
  r.resbar = reinterpret_cast<uint64_t*>(r.rows + BST * 2 * BQT);
  r.full = r.resbar + 1;
  r.empty = r.full + BST;
  const Shape& sh = args.a.sh;
  // Heads in groups of args.group; within a group, rank by rank, the
  // group's dK/dV blocks of key tile `rank` and then its dQ blocks of query
  // tile nq - 1 - rank: under the causal mask the longest of both first.
  const int nk = (sh.Lk + RES - 1) / RES, nq = (sh.Lq + RES - 1) / RES;
  const int per = args.group * (nk + nq);
  const int grp = blockIdx.x / per, idx = blockIdx.x % per;
  const int size = min(args.group, sh.B * sh.H - grp * args.group);  // the last may be smaller
  const int both = min(nk, nq);  // ranks with blocks of both roles
  bool dq;
  int rank, head;
  if (idx < 2 * size * both) {
    rank = idx / (2 * size);
    dq = idx % (2 * size) >= size;
    head = idx % size;
  } else {
    const int x = idx - 2 * size * both;
    rank = both + x / size;
    dq = nq > nk;
    head = x % size;
  }
  const int bh = grp * args.group + head, b = bh / sh.H, h = bh % sh.H;
  const int row0 = (dq ? nq - 1 - rank : rank) * RES;
  int t0, t1;
  if (dq)
    key_range<RES, KT>(sh, row0, t0, t1);
  else
    query_range<BQT, RES>(sh, row0, t0, t1);
  const int n = t1 > t0 ? t1 - t0 : 0;
  if (threadIdx.x == 0) {
    mbar_init(r.resbar, 1);
    for (int s = 0; s < BST; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n > 0) produce<DP>(args, r, dq, row0, t0, n, bh, h, b);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    if (dq)
      consume_dq<DP>(args, r, row0, t0, n, bh, h, b);
    else
      consume_dkv<DP>(args, r, row0, t0, n, h, b);
  }
}

}  // namespace wgb

// delta = rowsum(dO * O) in f32, (B H, ld): 16 threads a row, 8 elements
// each (D <= 128), loaded 16 bytes at a time where every row is 16-byte
// aligned and D % 8 == 0; rows Lq .. ld - 1 are 0.  Where lse2 is given,
// also lse2 = lse log2e, (B H, ld), 0 past Lq: the wgmma backward's copies.
// Bound by reading dO and O once.
template <typename T>
struct DeltaArgs {
  const T *dout, *out;
  View vdo, vo;
  const float* lse;
  float *delta, *lse2;
  int H, Lq, D, ld, rows, vec;  // rows = B H ld
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta(const __grid_constant__ DeltaArgs<T> a) {
  const int row = blockIdx.x * 16 + threadIdx.x / 16, t = threadIdx.x % 16, c0 = 8 * t;
  const int bh = row / a.ld, l = row % a.ld;
  float acc = 0.f;
  if (row < a.rows && l < a.Lq && c0 < a.D) {
    const int b = bh / a.H, h = bh % a.H;
    const T* pd = a.dout + b * a.vdo.sb + h * a.vdo.sh + l * a.vdo.sl + c0;
    const T* po = a.out + b * a.vo.sb + h * a.vo.sh + l * a.vo.sl + c0;
    if (a.vec) {
      float x[8], y[8];
      load8(x, pd);
      load8(y, po);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    } else {
      for (int e = 0; e < 8 && c0 + e < a.D; ++e) acc = fmaf(to_f32(pd[e]), to_f32(po[e]), acc);
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (t == 0 && row < a.rows) {
    a.delta[row] = acc;
    if (a.lse2 != nullptr)
      a.lse2[row] = l < a.Lq ? a.lse[(long long)bh * a.Lq + l] * wg::LOG2E : 0.f;
  }
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

Shape shape(const long long* m, float scale) {
  return Shape{(int)m[0], (int)m[1], (int)m[2], (int)m[3], (int)m[4], (int)m[5], (int)m[6],
               (int)m[7], scale};
}

template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, const Args& a, dim3 grid, int threads, int smem,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t fwd_bf16(const FwdArgs<__nv_bfloat16>& a, cudaStream_t st) {
  const dim3 grid((a.sh.Lq + BQ - 1) / BQ, a.sh.B * a.sh.H);
  // Q and two buffers of K and V
  return launch(tc::flash_fwd_tc<DP>, a, grid, tc::TC_THREADS, 5 * tc::tile_bytes<DP>(), st);
}

// A (D, L, H, B) tensor map of a (B, H, L, D) view with L rows `len`, in
// boxes of 64 x `rows`; the route guarantees the strides TMA needs
bool encode_heads(CUtensorMap* map, const __nv_bfloat16* base, const Shape& sh, int len,
                  const View& v, int rows) {
  const long long dims[4] = {sh.D, len, sh.H, sh.B};
  const long long strides[3] = {2 * v.sl, 2 * v.sh, 2 * v.sb};  // bytes
  return dft::hopper::encode_bf16_4d(map, base, dims, strides, rows);
}

// The maps are encoded on every call: the pointers change.
template <int DP>
cudaError_t fwd_wgmma(const FwdArgs<__nv_bfloat16>& a, cudaStream_t st) {
  wg::Args w;
  w.a = a;
  w.group = wg::heads_in_l2(a.sh);
  if (!encode_heads(&w.maps.q, a.q, a.sh, a.sh.Lq, a.vq, wg::BQW) ||
      !encode_heads(&w.maps.k, a.k, a.sh, a.sh.Lk, a.vk, wg::BKT) ||
      !encode_heads(&w.maps.v, a.v, a.sh, a.sh.Lk, a.vv, wg::BKT))
    return cudaErrorInvalidValue;
  const dim3 grid(a.sh.B * a.sh.H * ((a.sh.Lq + wg::BQW - 1) / wg::BQW));
  return launch(wg::flash_fwd_wgmma<DP>, w, grid, wg::WG_THREADS, wg::Layout<DP>::SMEM, st);
}

template <int DP>
cudaError_t fwd_f32(const FwdArgs<float>& a, cudaStream_t st) {
  const dim3 grid((a.sh.Lq + BQ - 1) / BQ, a.sh.B * a.sh.H);
  const int smem = ((BQ + 2 * BK) * (DP + 1) + BQ * PLD) * 4;
  return launch(flash_fwd_f32<DP>, a, grid, THREADS, smem, st);
}

template <int DP>
cudaError_t bwd_bf16(const BwdArgs<__nv_bfloat16>& a, cudaStream_t st) {
  const int nq = (a.sh.Lq + BQ - 1) / BQ, nk = (a.sh.Lk + BK - 1) / BK;
  const dim3 grid(nq > nk ? nq : nk, a.sh.B * a.sh.H, 2);
  // the dk/dv role's K and V and two buffers of Q, dO, lse and delta (the
  // dq role's Q, dO and two buffers of K and V take less)
  return launch(tc::flash_bwd_tc<DP>, a, grid, tc::TC_THREADS,
                6 * tc::tile_bytes<DP>() + 4 * BQ * 4, st);
}

// The dK/dV role's blocks of every key tile and the dQ role's of every
// query tile, one launch; the maps are encoded on every call.
template <int DP>
cudaError_t bwd_wgmma(const BwdArgs<__nv_bfloat16>& a, int ld, cudaStream_t st) {
  wgb::Args w;
  w.a = a;
  w.group = wgb::heads_in_l2(a.sh);
  w.ld = ld;
  if (ld % 128 || !encode_heads(&w.maps.q, a.q, a.sh, a.sh.Lq, a.vq, 64) ||
      !encode_heads(&w.maps.k, a.k, a.sh, a.sh.Lk, a.vk, 64) ||
      !encode_heads(&w.maps.v, a.v, a.sh, a.sh.Lk, a.vv, 64) ||
      !encode_heads(&w.maps.dout, a.dout, a.sh, a.sh.Lq, a.vdo, 64))
    return cudaErrorInvalidValue;
  const int nk = (a.sh.Lk + wgb::RES - 1) / wgb::RES, nq = (a.sh.Lq + wgb::RES - 1) / wgb::RES;
  const dim3 grid(a.sh.B * a.sh.H * (nk + nq));
  return launch(wgb::flash_bwd_wgmma<DP>, w, grid, wgb::WG_THREADS, wgb::Layout<DP>::SMEM, st);
}

// whether every row of a (B, H, L, D) view starts 16-byte aligned
template <typename T>
bool rows_aligned(const void* p, const View& v, int D) {
  const long long e = sizeof(T);
  return D % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && v.sb * e % 16 == 0 &&
         v.sh * e % 16 == 0 && v.sl * e % 16 == 0;
}

// delta into stats[0 .. B H ld) and, on the wgmma route (2), lse log2e into
// stats[B H ld .. 2 B H ld)
template <typename T>
cudaError_t delta_pass(const long long* m, const void* dout, const void* out, const float* lse,
                       float* stats, cudaStream_t st) {
  DeltaArgs<T> d;
  d.dout = static_cast<const T*>(dout);
  d.out = static_cast<const T*>(out);
  d.vdo = view(m + 17);
  d.vo = view(m + 30);
  d.lse = lse;
  d.ld = (int)m[33];
  d.rows = (int)(m[0] * m[1] * d.ld);
  d.delta = stats;
  d.lse2 = m[29] == 2 ? stats + d.rows : nullptr;
  d.H = (int)m[1];
  d.Lq = (int)m[2];
  d.D = (int)m[4];
  d.vec = rows_aligned<T>(dout, d.vdo, d.D) && rows_aligned<T>(out, d.vo, d.D);
  return launch(flash_bwd_delta<T>, d, dim3((d.rows + 15) / 16), 256, 0, st);
}

template <int DP>
cudaError_t bwd_f32(const BwdArgs<float>& a, cudaStream_t st) {
  const int nq = (a.sh.Lq + BQ - 1) / BQ, nk = (a.sh.Lk + BK - 1) / BK;
  const dim3 grid(nq > nk ? nq : nk, a.sh.B * a.sh.H, 2);
  // the larger of the dq role (q, dO, k, v, dS) and the dk/dv role
  // (k, v, q, dO, P^T, dS^T, lse, delta)
  const int smem = ((2 * BQ + 2 * BK) * (DP + 1) + 2 * BK * PLD + 2 * BQ) * 4;
  return launch(flash_bwd_f32<DP>, a, grid, THREADS, smem, st);
}

template <typename T>
FwdArgs<T> fwd_args(const long long* m, const void* q, const void* k, const void* v, void* o,
                    float* lse, float scale) {
  return FwdArgs<T>{shape(m, scale), static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(o), lse,
                    view(m + 8), view(m + 11), view(m + 14), view(m + 17)};
}

template <typename T>
BwdArgs<T> bwd_args(const long long* m, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta, void* dq, void* dk,
                    void* dv, float scale) {
  return BwdArgs<T>{shape(m, scale),
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                    static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                    view(m + 8), view(m + 11), view(m + 14), view(m + 17), view(m + 20),
                    view(m + 23), view(m + 26)};
}

}  // namespace

// meta: B, H, Lq, Lk, D, causal, window, vec, then the (B, H, L) element
// strides of q, k, v, out, then the route (0 f32 on the CUDA cores, 1
// mma.sync, 2 wgmma; ops/flash_attention.py _fwd_route).
// Returns the launch's cudaError_t; the caller raises if it is not 0.
extern "C" int dft_flash_fwd(const long long* meta, const void* q, const void* k,
                             const void* v, void* out, float* lse, float scale, int bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = meta[4] <= 64;
  const long long route = meta[20];
  if ((route == 0) == (bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (route == 2) {
    const auto a = fwd_args<__nv_bfloat16>(meta, q, k, v, out, lse, scale);
    e = small ? fwd_wgmma<64>(a, s) : fwd_wgmma<128>(a, s);
  } else if (route == 1) {
    const auto a = fwd_args<__nv_bfloat16>(meta, q, k, v, out, lse, scale);
    e = small ? fwd_bf16<64>(a, s) : fwd_bf16<128>(a, s);
  } else {
    const auto a = fwd_args<float>(meta, q, k, v, out, lse, scale);
    e = small ? fwd_f32<64>(a, s) : fwd_f32<128>(a, s);
  }
  return static_cast<int>(e);
}

// meta: B, H, Lq, Lk, D, causal, window, vec, then the strides of q, k, v,
// dout, dq, dk, dv, then the route (as dft_flash_fwd's; ops/flash_attention.py
// _bwd_route), then the strides of out, then ld, the row length of the f32
// scratch `stats`: Lq on routes 0 and 1, whose kernels read delta (B H,
// Lq); on the wgmma route a multiple of 128 at least Lq, and stats holds
// delta and then lse log2e, each (B H, ld).  flash_bwd_delta fills stats
// from dout, out and lse before the main kernel, on the same stream.
// Returns the first failed launch's cudaError_t, or 0.
extern "C" int dft_flash_bwd(const long long* meta, const void* q, const void* k,
                             const void* v, const void* dout, const void* out, const float* lse,
                             float* stats, void* dq, void* dk, void* dv, float scale, int bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = meta[4] <= 64;
  const long long route = meta[29];
  if ((route == 0) == (bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = bf16 ? delta_pass<__nv_bfloat16>(meta, dout, out, lse, stats, s)
                       : delta_pass<float>(meta, dout, out, lse, stats, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* delta = stats;
  if (route == 2) {
    const int ld = (int)meta[33];
    const float* lse2 = stats + meta[0] * meta[1] * ld;
    const auto a = bwd_args<__nv_bfloat16>(meta, q, k, v, dout, lse2, delta, dq, dk, dv, scale);
    e = small ? bwd_wgmma<64>(a, ld, s) : bwd_wgmma<128>(a, ld, s);
  } else if (route == 1) {
    const auto a = bwd_args<__nv_bfloat16>(meta, q, k, v, dout, lse, delta, dq, dk, dv, scale);
    e = small ? bwd_bf16<64>(a, s) : bwd_bf16<128>(a, s);
  } else {
    const auto a = bwd_args<float>(meta, q, k, v, dout, lse, delta, dq, dk, dv, scale);
    e = small ? bwd_f32<64>(a, s) : bwd_f32<128>(a, s);
  }
  return static_cast<int>(e);
}

// The delta pass alone, as dft_flash_bwd runs it (the same header and
// stats).  For timing it apart.
extern "C" int dft_flash_bwd_delta(const long long* meta, const void* dout, const void* out,
                                   const float* lse, float* stats, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? delta_pass<__nv_bfloat16>(meta, dout, out, lse, stats, s)
                               : delta_pass<float>(meta, dout, out, lse, stats, s));
}
