"""Int8 matrix products of the quantised KV-cache decoder (counterpart of the
int8 part of ``deepflows_tpu/ops/pallas_kernels.py``).

- ``quantize_int8`` / ``quantize_int8_rows``: per-column and per-row
  symmetric int8 quantisation, plain PyTorch as they are plain jnp in JAX.
- ``int8_matmul(x, wq, scale)``: ``x @ (wq · scale[col])``, f32
  accumulation, scale applied once after the K sum
  (``csrc/int8_matmul.cu``).
- ``w8a8_matmul(xq, sx, wq, sw)``: ``(xq · sx[row]) @ (wq · sw[col])``, exact
  int32 accumulation (``csrc/w8a8_matmul.cu``).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take.  On CPU tensors it calls its plain twin
(``*_plain``); on CUDA tensors it launches the kernel on the current stream
or raises, and counts the launch in ``<wrapper>.launches``.  A launch
captured into a CUDA graph by ``jit.StepGraphs`` counts once a replay
instead, so the count is of launches that ran on the card.  At decode
shapes (at most 8 rows, K up to 8192) both kernels split K across the
blocks of a cluster as ``_decode_plan`` says, in one launch that needs no
workspace; at every other shape they run a tensor-core tile whose rows
``_prefill_plan`` chooses.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import FLOATS, I, P, check, on_card, on_device, stream


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantisation of a (K, N) weight:
    returns (q int8 (K, N), scale f32 (N,)) with q · scale ≈ w."""
    wf = w.float()
    a = wf.abs().amax(0)
    scale = torch.where(a == 0.0, 1.0, a / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_int8_rows(x):
    """Per-row dynamic symmetric int8 quantisation of (M, K) activations:
    returns (xq int8 (M, K), sx f32 (M,)) with xq · sx[:, None] ≈ x."""
    xf = x.float()
    amax = xf.abs().amax(1)
    sx = torch.where(amax == 0.0, 1.0, amax / 127.0)
    xq = torch.clamp(torch.round(xf / sx[:, None]), -127, 127)
    return xq.to(torch.int8), sx


def int8_matmul_plain(x, wq, scale, out_dtype=None):
    """Plain twin of ``int8_matmul``: f32 product, then the column scale."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return ((x.float() @ wq.float()) * scale).to(out_dtype)


def w8a8_matmul_plain(xq, sx, wq, sw, out_dtype=torch.float32):
    """Plain twin of ``w8a8_matmul``.  PyTorch has no general integer matmul
    on CUDA, so the product runs in float64, which holds every partial sum
    (|sum| <= K·127² < 2³¹ < 2⁵³) exactly; then f32 conversion and the two
    scales in the kernel's order, so it agrees with the kernel bit for bit
    on either device."""
    acc = xq.double() @ wq.double()
    return (acc.float() * sx[:, None] * sw).to(out_dtype)


DECODE_M = 8  # rows the split-K decode kernel takes
# as csrc/int8_tile.cuh decode:: has them: columns of a block's tile, the
# granularity and the most of a block's K rows, the most K splits (blocks
# of one cluster)
_TILE_N, _STEP, _CHUNK_MAX, _MAX_SPLITS = 32, 64, 512, 16
DECODE_K = _CHUNK_MAX * _MAX_SPLITS  # longest K of the decode kernel
_SMS = 132  # the H100's SMs
_MIN_BLOCKS = 2 * _SMS


def _decode_plan(m, n, k):
    """The split of a decode product (1 to 8 rows, K at most 8192) over
    blocks: ``(column tile, K chunk, splits)``, the grid being
    (ceil(n / tile), splits), split s taking K rows [s·chunk, min((s + 1)·
    chunk, k)) and a tile's splits forming one cluster.

    It takes the fewest splits that launch at least 264 blocks, or 16 when
    no count does; the chunk is k over the splits rounded up to 64."""
    if not 1 <= m <= DECODE_M or not 1 <= k <= DECODE_K:
        raise ValueError(
            f"the decode plan takes 1 to {DECODE_M} rows and K up to {DECODE_K}, "
            f"not ({m}, {k})"
        )
    tiles = -(-n // _TILE_N)
    for target in range(-(-k // _CHUNK_MAX), _MAX_SPLITS + 1):
        chunk = -(-k // (target * _STEP)) * _STEP
        splits = -(-k // chunk)
        if tiles * splits >= _MIN_BLOCKS:
            break
    return _TILE_N, chunk, splits


# as csrc/int8_tile.cuh prefill:: has them: the tile's columns, and its rows
# from the largest
_PREFILL_N, _PREFILL_MS = 128, (128, 64, 32)


def _prefill_plan(m, n, k):
    """The tile of a product that is not a decode call (more than 8 rows,
    or K above 8192): ``(tile_m, tile_n)``, the grid being (ceil(n /
    tile_n), ceil(m / tile_m)) blocks of one tile each, over all of K.

    It takes the largest tile that launches at least one block per SM
    (132), or the smallest when none does."""
    if m < 1 or k < 1 or (m <= DECODE_M and k <= DECODE_K):
        raise ValueError(
            f"the prefill plan takes more than {DECODE_M} rows or K above "
            f"{DECODE_K}, not ({m}, {k})"
        )
    tiles_n = -(-n // _PREFILL_N)
    for tile_m in _PREFILL_MS:
        if -(-m // tile_m) * tiles_n >= _SMS:
            break
    return tile_m, _PREFILL_N


def _plan_args(m, n, k):
    """The C entry's (chunk, splits, tile_m): the decode plan's split at
    decode shapes, the prefill plan's tile rows at any other."""
    if m <= DECODE_M and k <= DECODE_K:
        return (*_decode_plan(m, n, k)[1:], 0)
    return 0, 0, _prefill_plan(m, n, k)[0]


def int8_matmul(x, wq, scale, out_dtype=None):
    """x @ (wq · scale[col]) with in-kernel widening of the int8 weight.

    x: (M, K) f32/bf16; wq: (K, N) int8; scale: (N,) f32; the output is
    ``out_dtype`` (x's dtype by default; f32 or bf16)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    check("x", x, (None, None), FLOATS)
    m, k = x.shape
    check("wq", wq, (k, None), (torch.int8,))
    n = wq.shape[1]
    check("scale", scale, (n,), (torch.float32,))
    if out_dtype not in FLOATS:
        raise TypeError(f"out_dtype {out_dtype} is not f32 or bf16")
    if not on_card(x, wq, scale):
        return int8_matmul_plain(x, wq, scale, out_dtype)
    fn = _build.c_function(
        "int8_matmul", "dft_int8_matmul", (P, I, P, P, P, I, I, I, I, I, I, I, P)
    )
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with on_device(x.device):
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
            scale.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            m, n, k, *_plan_args(m, n, k), stream(),
        )
    _build.check(rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def w8a8_matmul(xq, sx, wq, sw, out_dtype=torch.float32):
    """(xq · sx[row]) @ (wq · sw[col]) with exact s8 × s8 → s32 accumulation.

    xq: (M, K) int8; sx: (M,) f32; wq: (K, N) int8; sw: (N,) f32; the output
    is ``out_dtype`` (f32 or bf16)."""
    check("xq", xq, (None, None), (torch.int8,))
    m, k = xq.shape
    if k * 127 * 127 >= 2**31:
        raise ValueError(
            f"w8a8_matmul: K={k} can overflow the int32 accumulator "
            "(K * 127^2 >= 2^31); split the contraction dimension"
        )
    check("sx", sx, (m,), (torch.float32,))
    check("wq", wq, (k, None), (torch.int8,))
    n = wq.shape[1]
    check("sw", sw, (n,), (torch.float32,))
    if out_dtype not in FLOATS:
        raise TypeError(f"out_dtype {out_dtype} is not f32 or bf16")
    if not on_card(xq, sx, wq, sw):
        return w8a8_matmul_plain(xq, sx, wq, sw, out_dtype)
    fn = _build.c_function(
        "w8a8_matmul", "dft_w8a8_matmul", (P, P, P, P, P, I, I, I, I, I, I, I, P)
    )
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    with on_device(xq.device):
        rc = fn(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), m, n, k,
            *_plan_args(m, n, k), stream(),
        )
    _build.check(rc, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
