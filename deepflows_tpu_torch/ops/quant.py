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
instead, so the count is of launches that ran on the card.  Each call
takes one of three routes (``_route``): at decode shapes (at most 8 rows,
K up to 8192) both kernels split K across the blocks of a cluster as
``_decode_plan`` says, in one launch that needs no workspace; at up to
``STREAM_M`` rows, and at most 8 rows with K above 8192, the stream does
the same on 128-column tiles through a ring that each block refills
(``_stream_plan``); at every other shape, prefill, each wrapper's own rule
picks the design: ``_prefill_route`` for ``int8_matmul`` (bf16 x that TMA
can read: the ``wgmma`` tile of ``_prefill_wgmma_plan``) and
``_w8a8_prefill_route`` for ``w8a8_matmul`` (s8 x and weight that TMA can
read: the same ``wgmma`` tile on 8-bit ``wgmma``, ``_w8a8_wgmma_plan``),
and the mma.sync tile of ``_prefill_plan`` for the rest ("mma").  Both
count their launches by route in ``<wrapper>.routes``.  The wgmma tile is
bound by operations, 2 M K N over 989 TFLOP/s (bf16) or 1,979 TOPS (s8);
PERF.md rows 5p and 7p hold its times beside those bounds.
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


# rows the stream takes (6 n8 tiles, csrc/int8_tile.cuh stream::MAX_NT):
# up to 48 it beat the prefill tile at all five of Mistral's matrices, at
# 64 not (tools/int8_decode_ab.py, PERF.md section 6)
STREAM_M = 48
# as csrc/int8_tile.cuh stream:: has them: a block's columns and its K
# step, the chunk's granularity
_STREAM_N, _STREAM_STEP = 128, 32


def _stream_plan(m, n, k):
    """The split of a product between decode and prefill (9 to STREAM_M
    rows at any K, or 1 to 8 rows with K above 8192) over blocks:
    ``(column tile, K chunk, splits)``, the grid and the clusters as in
    ``_decode_plan``.

    It takes the fewest splits (at most 16) that launch at least 264
    blocks; the chunk is k over the splits rounded up to 32, and has no
    upper limit, since the block refills its ring."""
    if not 1 <= m <= STREAM_M or k < 1 or (m <= DECODE_M and k <= DECODE_K):
        raise ValueError(
            f"the stream plan takes 1 to {STREAM_M} rows past the decode shapes "
            f"(at most {DECODE_M} rows and K {DECODE_K}), not ({m}, {k})"
        )
    tiles = -(-n // _STREAM_N)
    splits = next((s for s in range(1, _MAX_SPLITS + 1) if tiles * s >= _MIN_BLOCKS),
                  _MAX_SPLITS)
    chunk = -(-k // (splits * _STREAM_STEP)) * _STREAM_STEP
    return _STREAM_N, chunk, -(-k // chunk)


# as csrc/int8_tile.cuh prefill:: has them: the tile's columns, and its rows
# from the largest
_PREFILL_N, _PREFILL_MS = 128, (128, 64, 32)


def _prefill_plan(m, n, k):
    """The tile of a product with more than ``STREAM_M`` rows: ``(tile_m,
    tile_n)``, the grid being (ceil(n / tile_n), ceil(m / tile_m)) blocks
    of one tile each, over all of K.

    It takes the largest tile that launches at least one block per SM
    (132), or the smallest when none does."""
    if m <= STREAM_M or k < 1:
        raise ValueError(
            f"the prefill plan takes more than {STREAM_M} rows, not ({m}, {k})"
        )
    tiles_n = -(-n // _PREFILL_N)
    for tile_m in _PREFILL_MS:
        if -(-m // tile_m) * tiles_n >= _SMS:
            break
    return tile_m, _PREFILL_N


def _route(m, n, k):
    """The route of an (m, k) x (k, n) product: "decode" (at most 8 rows,
    K up to 8192), "stream" (up to STREAM_M rows otherwise) or
    "prefill"."""
    if m <= DECODE_M and k <= DECODE_K:
        return "decode"
    return "stream" if m <= STREAM_M else "prefill"


# both wrappers' launches are counted by these routes: "prefill" of _route
# is "wgmma" or "mma" (int8_matmul: _prefill_route; w8a8_matmul:
# _w8a8_prefill_route)
ROUTES = ("decode", "stream", "wgmma", "mma")
# The wgmma tiles, (rows, columns), as csrc/int8_tile.cuh
# launch_prefill_wgmma takes them, each with the microseconds one block
# takes over K rows, a + b K: fitted to the tile sweep of
# tools/int8_prefill_check.py on an H100 (PERF.md section 6), bf16 x for
# int8_matmul and s8 x for w8a8_matmul (its own sweep: s8's K rows run at
# twice bf16's tensor rate, but not at twice its speed a block)
_WGMMA_TILES = {(128, 256): (7.02, 0.01092), (128, 128): (5.63, 0.00544),
                (64, 128): (3.44, 0.00512)}
_W8A8_TILES = {(128, 256): (6.8, 0.00647), (128, 128): (3.25, 0.00422),
               (64, 128): (2.64, 0.00353)}


def _tma_reads(x, wq):
    """Whether TMA can read both operands of a prefill call: x's rows a
    multiple of 16 bytes, N a multiple of 16, both bases 16-byte aligned."""
    k, n = wq.shape
    return (k * x.element_size() % 16 == 0 and n % 16 == 0 and x.data_ptr() % 16 == 0
            and wq.data_ptr() % 16 == 0)


def _prefill_route(x, wq):
    """The design of an int8_matmul call that ``_route`` sends to
    "prefill": "wgmma" (the int8 weight widened in registers as wgmma's A
    operand, x's slices by TMA) where x is bf16 and TMA can read both
    operands (K a multiple of 8, N of 16, both bases 16-byte aligned), else
    "mma" (the mma.sync tile of ``_prefill_plan``: f32 x, ragged widths, a
    misaligned weight).  w8a8_matmul's calls follow ``_w8a8_prefill_route``."""
    return "wgmma" if x.dtype == torch.bfloat16 and _tma_reads(x, wq) else "mma"


def _int8_route(x, wq):
    """int8_matmul's route: ``_route``'s, with "prefill" refined by
    ``_prefill_route``."""
    route = _route(x.shape[0], wq.shape[1], wq.shape[0])
    return _prefill_route(x, wq) if route == "prefill" else route


def _w8a8_prefill_route(xq, wq):
    """The design of a w8a8_matmul call that ``_route`` sends to
    "prefill": "wgmma" (8-bit wgmma with exact s32 sums, the int8 weight as
    it is the register A operand, xq's slices by TMA) where TMA can read
    both operands (K a multiple of 16, xq's row stride in bytes; N of 16;
    both bases 16-byte aligned), else "mma" (the mma.sync tile of
    ``_prefill_plan``).  int8_matmul's calls follow ``_prefill_route``."""
    return "wgmma" if _tma_reads(xq, wq) else "mma"


def _w8a8_route(xq, wq):
    """w8a8_matmul's route: ``_route``'s, with "prefill" refined by
    ``_w8a8_prefill_route``."""
    route = _route(xq.shape[0], wq.shape[1], wq.shape[0])
    return _w8a8_prefill_route(xq, wq) if route == "prefill" else route


def _wgmma_plan(tiles, m, n, k):
    """The tile of a "wgmma" call: ``(tile_m, tile_n)``, the grid being
    (ceil(n / tile_n), ceil(m / tile_m)) blocks of one tile each, over all
    of K.

    It takes the tile of ``tiles`` (``_WGMMA_TILES`` or ``_W8A8_TILES``)
    whose waves of 132 blocks (one an SM) take the least time by its block
    times; the first of a tie."""
    if m <= STREAM_M or k < 1:
        raise ValueError(
            f"the wgmma prefill plan takes more than {STREAM_M} rows, not ({m}, {k})"
        )

    def cost(tile):
        (tile_m, tile_n), (a, b) = tile, tiles[tile]
        blocks = -(-m // tile_m) * -(-n // tile_n)
        return -(-blocks // _SMS) * (a + b * k)

    return min(tiles, key=cost)


def _prefill_wgmma_plan(m, n, k):
    """int8_matmul's wgmma tile (bf16 x), by ``_WGMMA_TILES``."""
    return _wgmma_plan(_WGMMA_TILES, m, n, k)


def _w8a8_wgmma_plan(m, n, k):
    """w8a8_matmul's wgmma tile (s8 x), by ``_W8A8_TILES``."""
    return _wgmma_plan(_W8A8_TILES, m, n, k)


def _plan_args(m, n, k):
    """The C entry's (chunk, splits, tile_m) of a call off the wgmma route,
    in either wrapper: the decode or stream plan's split, or the mma.sync
    tile's rows (``_prefill_plan``), as ``_route`` says.  Which prefill
    calls take the wgmma tile instead is each wrapper's own rule
    (``_launch_plan``)."""
    route = _route(m, n, k)
    if route == "prefill":
        return 0, 0, _prefill_plan(m, n, k)[0]
    plan = _decode_plan if route == "decode" else _stream_plan
    return (*plan(m, n, k)[1:], 0)


def _launch_plan(route, m, n, k, wgmma_plan):
    """A C entry's (chunk, splits, tile_m, tile_n) for a call on ``route``,
    as the calling wrapper's own rule chose it (``_int8_route`` or
    ``_w8a8_route``): on "wgmma" the wrapper's own tile (``wgmma_plan``:
    ``_prefill_wgmma_plan`` or ``_w8a8_wgmma_plan``), else
    ``_plan_args``' with tile_n 0."""
    if route == "wgmma":
        return (0, 0, *wgmma_plan(m, n, k))
    return (*_plan_args(m, n, k), 0)


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
        "int8_matmul", "dft_int8_matmul", (P, I, P, P, P, I, I, I, I, I, I, I, I, P)
    )
    route = _int8_route(x, wq)
    plan = _launch_plan(route, m, n, k, _prefill_wgmma_plan)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with on_device(x.device):
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
            scale.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            m, n, k, *plan, stream(),
        )
    _build.check(rc, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.routes[route] += 1
    return out


int8_matmul.launches = 0
int8_matmul.routes = dict.fromkeys(ROUTES, 0)  # launches by route, never reset


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
        "w8a8_matmul", "dft_w8a8_matmul", (P, P, P, P, P, I, I, I, I, I, I, I, I, P)
    )
    route = _w8a8_route(xq, wq)
    plan = _launch_plan(route, m, n, k, _w8a8_wgmma_plan)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    with on_device(xq.device):
        rc = fn(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), m, n, k, *plan, stream(),
        )
    _build.check(rc, "w8a8_matmul")
    w8a8_matmul.launches += 1
    w8a8_matmul.routes[route] += 1
    return out


w8a8_matmul.launches = 0
w8a8_matmul.routes = dict.fromkeys(ROUTES, 0)  # launches by route, never reset
