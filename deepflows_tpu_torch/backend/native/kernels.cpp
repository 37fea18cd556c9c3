// Native CPU kernel library for deepflows_tpu.
//
// TPU-native rebuild's analog of the reference's compiled CUDA extension
// (`DeepFlows/backend/backend_src/ndarray_backend_cuda.cu`, 716 LoC): the
// same kernel surface — fill / elementwise / scalar ops / compare / log /
// exp / tanh / matmul / trailing-axis reductions — implemented as a C
// library for the CPU device path.  The TPU compute path is XLA/Pallas (a
// C++ host extension cannot target the TPU); this module is where native
// code still earns its keep: a fast in-process CPU backend, loaded via
// ctypes (no pybind11 in this image).
//
// Layout contract (mirrors the reference's `.cu` constants at :15-19):
// float32 buffers, contiguous, max 8 dims handled by the Python layer.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// spawn up to hardware_concurrency workers over [0, n) in contiguous chunks
template <typename F>
void parallel_for(int64_t n, int64_t min_chunk, F body) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = std::max<int64_t>(
        1, std::min<int64_t>(hw ? hw : 1, n / std::max<int64_t>(min_chunk, 1)));
    if (nthreads <= 1) {
        body(0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk, hi = std::min(lo + chunk, n);
        if (lo >= hi) break;
        pool.emplace_back([=] { body(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

typedef float scalar_t;

void nat_fill(scalar_t* out, scalar_t val, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = val;
}

#define EWISE_BINOP(name, expr)                                            \
    void name(const scalar_t* a, const scalar_t* b, scalar_t* out,         \
              int64_t n) {                                                 \
        for (int64_t i = 0; i < n; ++i) out[i] = (expr);                   \
    }

EWISE_BINOP(nat_ewise_add, a[i] + b[i])
EWISE_BINOP(nat_ewise_sub, a[i] - b[i])
EWISE_BINOP(nat_ewise_mul, a[i] * b[i])
EWISE_BINOP(nat_ewise_div, a[i] / b[i])
EWISE_BINOP(nat_ewise_maximum, std::max(a[i], b[i]))
EWISE_BINOP(nat_ewise_eq, a[i] == b[i] ? 1.0f : 0.0f)
EWISE_BINOP(nat_ewise_ge, a[i] >= b[i] ? 1.0f : 0.0f)

#define SCALAR_OP(name, expr)                                              \
    void name(const scalar_t* a, scalar_t val, scalar_t* out, int64_t n) { \
        for (int64_t i = 0; i < n; ++i) out[i] = (expr);                   \
    }

SCALAR_OP(nat_scalar_add, a[i] + val)
SCALAR_OP(nat_scalar_mul, a[i] * val)
SCALAR_OP(nat_scalar_div, a[i] / val)
SCALAR_OP(nat_scalar_power, std::pow(a[i], val))
SCALAR_OP(nat_scalar_maximum, std::max(a[i], val))
SCALAR_OP(nat_scalar_eq, a[i] == val ? 1.0f : 0.0f)
SCALAR_OP(nat_scalar_ge, a[i] >= val ? 1.0f : 0.0f)

// ewise_log preserves the reference's -INF-for-nonpositive contract
// (`ndarray_backend_cuda.cu:403-414`)
void nat_ewise_log(const scalar_t* a, scalar_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = a[i] > 0.0f ? std::log(a[i]) : -INFINITY;
}

void nat_ewise_exp(const scalar_t* a, scalar_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = std::exp(a[i]);
}

void nat_ewise_tanh(const scalar_t* a, scalar_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = std::tanh(a[i]);
}

// Cache-blocked MULTITHREADED SGEMM: out[M,P] = a[M,N] @ b[N,P].  Replaces
// the reference's naive per-output-element kernel (`.cu:443-466`, TILE=4,
// no shared memory) with i-k-j loop order (unit-stride inner loop, FMA
// friendly), L1-sized blocking, and row-block threading.
void nat_matmul(const scalar_t* a, const scalar_t* b, scalar_t* out,
                int64_t M, int64_t N, int64_t P) {
    const int64_t BM = 64, BN = 256, BP = 512;
    parallel_for(M, BM, [=](int64_t m_lo, int64_t m_hi) {
        std::memset(out + m_lo * P, 0, sizeof(scalar_t) * (m_hi - m_lo) * P);
        for (int64_t i0 = m_lo; i0 < m_hi; i0 += BM)
            for (int64_t k0 = 0; k0 < N; k0 += BN)
                for (int64_t j0 = 0; j0 < P; j0 += BP) {
                    int64_t i1 = std::min(i0 + BM, m_hi);
                    int64_t k1 = std::min(k0 + BN, N);
                    int64_t j1 = std::min(j0 + BP, P);
                    for (int64_t i = i0; i < i1; ++i) {
                        scalar_t* orow = out + i * P;
                        const scalar_t* arow = a + i * N;
                        for (int64_t k = k0; k < k1; ++k) {
                            scalar_t av = arow[k];
                            const scalar_t* brow = b + k * P;
                            for (int64_t j = j0; j < j1; ++j)
                                orow[j] += av * brow[j];
                        }
                    }
                }
    });
}

// Fused im2col: NCHW input (already padded) -> column matrix
// (N*oh*ow, C*kh*kw) in one threaded pass.  Replaces the numpy
// as_strided-view + transpose + ascontiguousarray materialization (the
// reference's im2col was a python k x k slice loop,
// `DeepFlows/nn/functional.py:263-283`).
void nat_im2col(const scalar_t* x, scalar_t* cols, int64_t n, int64_t c,
                int64_t h, int64_t w, int64_t kh, int64_t kw, int64_t sh,
                int64_t sw, int64_t oh, int64_t ow) {
    int64_t rows = n * oh * ow;
    int64_t rowlen = c * kh * kw;
    parallel_for(rows, 1024, [=](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
            int64_t img = r / (oh * ow);
            int64_t oy = (r / ow) % oh;
            int64_t ox = r % ow;
            scalar_t* dst = cols + r * rowlen;
            const scalar_t* src = x + img * c * h * w + oy * sh * w + ox * sw;
            for (int64_t ch = 0; ch < c; ++ch) {
                const scalar_t* plane = src + ch * h * w;
                for (int64_t ky = 0; ky < kh; ++ky) {
                    std::memcpy(dst, plane + ky * w, sizeof(scalar_t) * kw);
                    dst += kw;
                }
            }
        }
    });
}

// Max pool 2d forward, NCHW (input already padded with -inf if needed).
void nat_max_pool2d(const scalar_t* x, scalar_t* out, int64_t n_c,
                    int64_t h, int64_t w, int64_t kh, int64_t kw,
                    int64_t sh, int64_t sw, int64_t oh, int64_t ow) {
    parallel_for(n_c, 8, [=](int64_t lo, int64_t hi) {
        for (int64_t p = lo; p < hi; ++p) {
            const scalar_t* plane = x + p * h * w;
            scalar_t* oplane = out + p * oh * ow;
            for (int64_t oy = 0; oy < oh; ++oy)
                for (int64_t ox = 0; ox < ow; ++ox) {
                    const scalar_t* win = plane + oy * sh * w + ox * sw;
                    scalar_t acc = win[0];
                    for (int64_t ky = 0; ky < kh; ++ky)
                        for (int64_t kx = 0; kx < kw; ++kx)
                            acc = std::max(acc, win[ky * w + kx]);
                    oplane[oy * ow + ox] = acc;
                }
        }
    });
}

// Train-mode batch norm over NCHW: per-channel biased mean/var (the
// reference's formula, `nn/modules/batchnorm.py:31-42`), normalize, affine.
// gamma/beta may be null (non-affine).  Threaded over channels.
void nat_batchnorm_train(const scalar_t* x, const scalar_t* gamma,
                         const scalar_t* beta, scalar_t* out,
                         scalar_t* mean_out, scalar_t* var_out, int64_t n,
                         int64_t c, int64_t hw, scalar_t eps) {
    parallel_for(c, 1, [=](int64_t c_lo, int64_t c_hi) {
        for (int64_t ch = c_lo; ch < c_hi; ++ch) {
            double sum = 0.0, sq = 0.0;
            for (int64_t img = 0; img < n; ++img) {
                const scalar_t* base = x + (img * c + ch) * hw;
                for (int64_t i = 0; i < hw; ++i) {
                    sum += base[i];
                    sq += (double)base[i] * base[i];
                }
            }
            double cnt = (double)n * hw;
            scalar_t m = (scalar_t)(sum / cnt);
            scalar_t v = (scalar_t)(sq / cnt - (double)m * m);
            if (v < 0) v = 0;
            mean_out[ch] = m;
            var_out[ch] = v;
            scalar_t inv = 1.0f / std::sqrt(v + eps);
            scalar_t g = gamma ? gamma[ch] : 1.0f;
            scalar_t b = beta ? beta[ch] : 0.0f;
            scalar_t scale = g * inv, shift = b - m * scale;
            for (int64_t img = 0; img < n; ++img) {
                const scalar_t* base = x + (img * c + ch) * hw;
                scalar_t* obase = out + (img * c + ch) * hw;
                for (int64_t i = 0; i < hw; ++i)
                    obase[i] = base[i] * scale + shift;
            }
        }
    });
}

// Trailing-axis reductions (reference `.cu:469-509`): out[i] reduces
// `reduce_size` contiguous elements.
void nat_reduce_sum(const scalar_t* a, scalar_t* out, int64_t out_n,
                    int64_t reduce_size) {
    for (int64_t i = 0; i < out_n; ++i) {
        scalar_t acc = 0.0f;
        const scalar_t* base = a + i * reduce_size;
        for (int64_t j = 0; j < reduce_size; ++j) acc += base[j];
        out[i] = acc;
    }
}

void nat_reduce_max(const scalar_t* a, scalar_t* out, int64_t out_n,
                    int64_t reduce_size) {
    for (int64_t i = 0; i < out_n; ++i) {
        const scalar_t* base = a + i * reduce_size;
        scalar_t acc = base[0];
        for (int64_t j = 1; j < reduce_size; ++j) acc = std::max(acc, base[j]);
        out[i] = acc;
    }
}

int nat_version() { return 2; }

}  // extern "C"
