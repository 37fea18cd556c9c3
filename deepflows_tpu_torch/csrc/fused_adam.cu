// fused_adam: one elementwise Adam pass over a list of f32 parameters, in
// place, in ONE launch for the whole list.
//
// Replaces the TPU kernel deepflows_tpu/ops/pallas_kernels.py fused_adam
// (_adam_kernel), which updates one raveled parameter per call.  For each
// element, in the TPU kernel's order:
//   g += p * wd;  v = v * b1 + g * (1 - b1);  s = s * b2 + g * g * (1 - b2);
//   p -= lr * (v / bc1) / (sqrt(s / bc2) + eps)
// with hyper = f32[7] {lr, b1, b2, eps, wd, bc1 = 1 - b1^t, bc2 = 1 - b2^t}
// read from device memory, so a training step sets it without a host sync.
// Each operation rounds on its own (__fmul_rn and friends: no FMA
// contraction), so the kernel agrees bit for bit with the same expression
// evaluated one PyTorch op at a time.
//
// What bounds it on an H100: 28 bytes an element (read p, g, v, s; write
// p, v, s), so the bytes over 3.35 TB/s: 1.41 ms for the training slice's
// 168,990,720 elements in 198 tensors.  Multi-tensor form: the caller
// passes a device table of (p, g, v, s, n) per tensor and the first block
// of each tensor; block b finds its tensor by binary search over those
// starts and updates `chunk` consecutive elements, each thread every
// 256th, so a warp's loads are coalesced.  198 tensors take one launch,
// not 198.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(const long long* __restrict__ table, int T, int chunk,
                  const float* __restrict__ hyper) {
  const long long* starts = table + 5 * T;
  const long long blk = blockIdx.x;
  int lo = 0, hi = T - 1;  // the last tensor whose first block is <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (starts[mid] <= blk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long* e = table + 5 * lo;
  float* p = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* v = reinterpret_cast<float*>(e[2]);
  float* s = reinterpret_cast<float*>(e[3]);
  const long long n = e[4];
  const float lr = hyper[0], b1 = hyper[1], b2 = hyper[2], eps = hyper[3], wd = hyper[4];
  const float bc1 = hyper[5], bc2 = hyper[6];
  const float c1 = __fsub_rn(1.f, b1), c2 = __fsub_rn(1.f, b2);
  const long long begin = (blk - starts[lo]) * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
    const float pi = p[i];
    const float gi = __fadd_rn(g[i], __fmul_rn(pi, wd));
    const float vi = __fadd_rn(__fmul_rn(v[i], b1), __fmul_rn(gi, c1));
    const float si = __fadd_rn(__fmul_rn(s[i], b2), __fmul_rn(__fmul_rn(gi, gi), c2));
    v[i] = vi;
    s[i] = si;
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(si, bc2)), eps);
    p[i] = __fsub_rn(pi, __fdiv_rn(__fmul_rn(lr, __fdiv_rn(vi, bc1)), den));
  }
}

}  // namespace

// table: device int64 [6 * T + 1]: (p, g, v, s pointers, n) per tensor, then
// each tensor's first block and the total block count.  Returns the
// launch's cudaError_t; the caller raises if it is not 0.
extern "C" int dft_fused_adam(const long long* table, int T, long long blocks, int chunk,
                              const float* hyper, void* stream) {
  fused_adam_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, T, chunk, hyper);
  return static_cast<int>(cudaGetLastError());
}
