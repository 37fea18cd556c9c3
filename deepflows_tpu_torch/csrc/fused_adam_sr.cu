// fused_adam_sr: Adam over a list of bf16 parameters whose new value is
// stochastically rounded to bf16, in place, in ONE launch for the whole
// list.
//
// Replaces the TPU kernel deepflows_tpu/ops/pallas_kernels.py fused_adam_sr
// (_adam_sr_math, _stochastic_round_bf16), which updates one raveled
// parameter per call.  For each element, in the TPU kernel's order:
//   p32 = f32(p);  g = f32(g) + p32 * wd;
//   v = v * b1 + g * (1 - b1);  s = s * b2 + g * g * (1 - b2);
//   p32' = p32 - lr * (v / bc1) / (sqrt(s / bc2) + eps)
//   p = bf16((bits(p32') + (r & 0xFFFF)) & 0xFFFF0000)
// with hyper = f32[7] {lr, b1, b2, eps, wd, bc1, bc2} and the step count t
// read from device memory, so a training step needs no host sync.  The
// rounding adds 16 random bits below bf16's last mantissa bit and then
// truncates: unbiased, so an update smaller than half a bf16 ulp still
// moves the weight in expectation.  Each operation rounds on its own
// (__fmul_rn and friends: no FMA contraction), so the kernel agrees bit for
// bit with the same expression evaluated one PyTorch op at a time.
//
// Random bits.  The TPU kernel draws them from the TPU's own generator.
// Here each tensor of the list has a Philox4x32-10 stream keyed by the JAX
// package's seed t * 1009 + i (i: the tensor's position in the optimizer's
// parameter list; int32 wrap-around), whose counter is the element index
// over 4: one Philox call gives the four words of four consecutive
// elements.  A second entry takes external u32 bits, one per element, so
// tests can feed the bits the JAX package draws.
//
// What bounds it on an H100: 22 bytes an element (read bf16 p and g, f32 v
// and s; write p, v, s; with an f32 g 24), so the bytes over 3.35 TB/s:
// 1.11 ms for the training slice's 168,990,720 elements.  Philox costs 40
// integer multiplies for four elements, below that bound.  Multi-tensor
// form as in fused_adam.cu: a device table of (p, g, v, s, bits, n, i,
// g is bf16, aligned) per tensor and each tensor's first block; block b
// finds its tensor by binary search and updates `chunk` consecutive
// elements, each thread a group of four with one Philox call, and, where
// the tensors are aligned for it, one 8- or 16-byte access per operand.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 9;  // table entries per tensor

__device__ __forceinline__ void philox4x32_10(uint32_t k0, uint32_t k1, uint32_t c0,
                                              uint32_t c1, uint32_t out[4]) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

template <bool EXTERNAL_BITS>
__global__ void __launch_bounds__(THREADS)
fused_adam_sr_kernel(const long long* __restrict__ table, int T, int chunk,
                     const float* __restrict__ hyper, const int* __restrict__ step) {
  const long long* starts = table + ROW * T;
  const long long blk = blockIdx.x;
  int lo = 0, hi = T - 1;  // the last tensor whose first block is <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (starts[mid] <= blk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long* e = table + ROW * lo;
  unsigned short* p = reinterpret_cast<unsigned short*>(e[0]);
  const float* g32 = reinterpret_cast<const float*>(e[1]);
  const unsigned short* g16 = reinterpret_cast<const unsigned short*>(e[1]);
  float* v = reinterpret_cast<float*>(e[2]);
  float* s = reinterpret_cast<float*>(e[3]);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(e[4]);
  const long long n = e[5];
  const uint32_t seed = static_cast<uint32_t>(step[0]) * 1009u + static_cast<uint32_t>(e[6]);
  const bool g_bf16 = e[7] != 0;
  const bool vec = e[8] != 0;  // every operand aligned for the wide accesses
  const float lr = hyper[0], b1 = hyper[1], b2 = hyper[2], eps = hyper[3], wd = hyper[4];
  const float bc1 = hyper[5], bc2 = hyper[6];
  const float c1 = __fsub_rn(1.f, b1), c2 = __fsub_rn(1.f, b2);
  const long long begin = (blk - starts[lo]) * chunk;  // chunk is a multiple of 4
  const long long end = begin + chunk < n ? begin + chunk : n;
  for (long long q = begin + 4 * threadIdx.x; q < end; q += 4 * THREADS) {
    const int cnt = end - q < 4 ? static_cast<int>(end - q) : 4;
    const bool wide = vec && cnt == 4;  // one 8- or 16-byte access per operand
    uint32_t r[4] = {0u, 0u, 0u, 0u}, p16[4] = {0u, 0u, 0u, 0u};
    float ga[4] = {0.f, 0.f, 0.f, 0.f}, va[4] = {0.f, 0.f, 0.f, 0.f}, sa[4] = {0.f, 0.f, 0.f, 0.f};
    if (EXTERNAL_BITS) {
      if (wide) {
        const uint4 b4 = *reinterpret_cast<const uint4*>(bits + q);
        r[0] = b4.x; r[1] = b4.y; r[2] = b4.z; r[3] = b4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < cnt) r[j] = bits[q + j];
      }
    } else {
      philox4x32_10(seed, 0u, static_cast<uint32_t>(q >> 2), static_cast<uint32_t>(q >> 34), r);
    }
    if (wide) {
      const uint2 pp = *reinterpret_cast<const uint2*>(p + q);
      p16[0] = pp.x & 0xFFFFu; p16[1] = pp.x >> 16; p16[2] = pp.y & 0xFFFFu; p16[3] = pp.y >> 16;
      if (g_bf16) {
        const uint2 g2 = *reinterpret_cast<const uint2*>(g16 + q);
        ga[0] = __uint_as_float(g2.x << 16); ga[1] = __uint_as_float(g2.x & 0xFFFF0000u);
        ga[2] = __uint_as_float(g2.y << 16); ga[3] = __uint_as_float(g2.y & 0xFFFF0000u);
      } else {
        const float4 g4 = *reinterpret_cast<const float4*>(g32 + q);
        ga[0] = g4.x; ga[1] = g4.y; ga[2] = g4.z; ga[3] = g4.w;
      }
      const float4 v4 = *reinterpret_cast<const float4*>(v + q);
      const float4 s4 = *reinterpret_cast<const float4*>(s + q);
      va[0] = v4.x; va[1] = v4.y; va[2] = v4.z; va[3] = v4.w;
      sa[0] = s4.x; sa[1] = s4.y; sa[2] = s4.z; sa[3] = s4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= cnt) break;
        p16[j] = p[q + j];
        ga[j] = g_bf16 ? __uint_as_float(static_cast<uint32_t>(g16[q + j]) << 16) : g32[q + j];
        va[j] = v[q + j];
        sa[j] = s[q + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pi = __uint_as_float(p16[j] << 16);
      const float gi = __fadd_rn(ga[j], __fmul_rn(pi, wd));
      va[j] = __fadd_rn(__fmul_rn(va[j], b1), __fmul_rn(gi, c1));
      sa[j] = __fadd_rn(__fmul_rn(sa[j], b2), __fmul_rn(__fmul_rn(gi, gi), c2));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(sa[j], bc2)), eps);
      const float pn = __fsub_rn(pi, __fdiv_rn(__fmul_rn(lr, __fdiv_rn(va[j], bc1)), den));
      p16[j] = ((__float_as_uint(pn) + (r[j] & 0xFFFFu)) & 0xFFFF0000u) >> 16;
    }
    if (wide) {
      *reinterpret_cast<uint2*>(p + q) = make_uint2(p16[0] | (p16[1] << 16), p16[2] | (p16[3] << 16));
      *reinterpret_cast<float4*>(v + q) = make_float4(va[0], va[1], va[2], va[3]);
      *reinterpret_cast<float4*>(s + q) = make_float4(sa[0], sa[1], sa[2], sa[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= cnt) break;
        p[q + j] = static_cast<unsigned short>(p16[j]);
        v[q + j] = va[j];
        s[q + j] = sa[j];
      }
    }
  }
}

}  // namespace

// table: device int64 [10 * T + 1]: (p, g, v, s, bits pointers, n, i,
// g is bf16, aligned) per tensor, aligned meaning that p and a bf16 g start
// on 8 bytes and v, s, an f32 g and bits on 16, then each tensor's first block and the total block
// count.  step: device int32, the step count t (from 1).  external_bits
// picks the entry that reads each tensor's bits pointer instead of drawing
// Philox bits.  Returns the launch's cudaError_t; the caller raises if it
// is not 0.
extern "C" int dft_fused_adam_sr(const long long* table, int T, long long blocks, int chunk,
                                 const float* hyper, const int* step, int external_bits,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (external_bits)
    fused_adam_sr_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(table, T, chunk, hyper, step);
  else
    fused_adam_sr_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(table, T, chunk, hyper, step);
  return static_cast<int>(cudaGetLastError());
}
