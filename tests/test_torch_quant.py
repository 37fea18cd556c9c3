"""The port's int8 kernels' plain twins (deepflows_tpu_torch/ops/quant.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

Inputs are numpy arrays from a seed, handed to both packages.  Tolerances:
quantisation and w8a8 are bit-exact (integer sums, then the same f32 ops in
the same order); int8_matmul uses tests/test_pallas.py's rtol 1e-4 and atol
1e-3, since the f32 sums run in another order.  On CPU tensors the wrappers
take the plain twins and never count a launch.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflows_tpu.ops import pallas_kernels as pk
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.ops import quant

RNG = np.random.default_rng(21)


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


@pytest.mark.parametrize("shape", [(64, 48), (512, 512), (70, 50), (16, 4)])
def test_quantize_int8_bit_exact(shape):
    w = RNG.standard_normal(shape).astype(np.float32) * 0.3
    if shape == (16, 4):
        w[:, 1] = 0.0  # a zero column takes scale 1
    jq, js = pk.quantize_int8(jnp.asarray(w))
    tq, ts = quant.quantize_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_rows_bit_exact(dtype):
    x = RNG.standard_normal((33, 300)).astype(np.float32)
    x[5] = 0.0  # a zero row takes scale 1
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = pk.quantize_int8_rows(jx)
    tq, ts = quant.quantize_int8_rows(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", [(16, 512, 512), (100, 70, 50), (129, 256, 300)])
def test_int8_matmul_plain_matches_jax(m, k, n):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.1
    jq, js = pk.quantize_int8(jnp.asarray(w))
    want = np.asarray(pk.int8_matmul(jnp.asarray(x), jq, js))
    tq, ts = quant.quantize_int8(torch.from_numpy(w))
    got = ops.int8_matmul(torch.from_numpy(x), tq, ts)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("out", [None, "float32"])
def test_int8_matmul_plain_bf16_activations(out):
    x = RNG.standard_normal((16, 256)).astype(np.float32)
    w = RNG.standard_normal((256, 128)).astype(np.float32) * 0.1
    jq, js = pk.quantize_int8(jnp.asarray(w))
    tq, ts = quant.quantize_int8(torch.from_numpy(w))
    want = pk.int8_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jq, js,
        out_dtype=None if out is None else jnp.float32,
    )
    got = ops.int8_matmul(
        torch.from_numpy(x).bfloat16(), tq, ts,
        out_dtype=None if out is None else torch.float32,
    )
    assert str(got.dtype).endswith(str(want.dtype))
    # f32 out: the JAX tests' bound; bf16 out: one bf16 ulp (<= 2^-7 |v|)
    rtol = 1e-4 if out else 2**-7
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=1e-3
    )


@pytest.mark.parametrize("m,k,n", [(1, 96, 80), (5, 256, 128), (33, 512, 300)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_w8a8_matmul_plain_exact_against_jax(m, k, n, out):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32)
    jxq, jsx = pk.quantize_int8_rows(jnp.asarray(x))
    jwq, jsw = pk.quantize_int8(jnp.asarray(w))
    want = pk.w8a8_matmul(jxq, jsx, jwq, jsw, out_dtype=getattr(jnp, out))
    txq, tsx = quant.quantize_int8_rows(torch.from_numpy(x))
    twq, tsw = quant.quantize_int8(torch.from_numpy(w))
    got = ops.w8a8_matmul(txq, tsx, twq, tsw, out_dtype=getattr(torch, out))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want, np.float32)
    )


def test_w8a8_k_overflow_guard():
    k = 133_632  # k * 127^2 = 2.155e9 >= 2^31
    xq = torch.zeros((8, k), dtype=torch.int8)
    wq = torch.zeros((k, 8), dtype=torch.int8)
    ones = torch.ones(8)
    with pytest.raises(ValueError, match="overflow"):
        ops.w8a8_matmul(xq, ones, wq, ones)


def _int8_args():
    x = torch.from_numpy(RNG.standard_normal((4, 32)).astype(np.float32))
    wq, s = quant.quantize_int8(torch.from_numpy(RNG.standard_normal((32, 16)).astype(np.float32)))
    return x, wq, s


@pytest.mark.parametrize(
    "bad",
    ["x_not_contiguous", "x_int", "w_float", "k_mismatch", "scale_f64",
     "scale_len", "out_int", "empty"],
)
def test_int8_matmul_rejects_what_the_kernel_does_not_take(bad):
    x, wq, s = _int8_args()
    kw = {}
    if bad == "x_not_contiguous":
        x = torch.cat([x, x], 1)[:, ::2]
    elif bad == "x_int":
        x = x.to(torch.int32)
    elif bad == "w_float":
        wq = wq.float()
    elif bad == "k_mismatch":
        wq = wq[:31].contiguous()
    elif bad == "scale_f64":
        s = s.double()
    elif bad == "scale_len":
        s = s[:15]
    elif bad == "out_int":
        kw["out_dtype"] = torch.int32
    elif bad == "empty":
        x = x[:0]
    with pytest.raises((ValueError, TypeError)):
        ops.int8_matmul(x, wq, s, **kw)


@pytest.mark.parametrize("bad", ["xq_float", "sx_len", "sw_bf16", "k_mismatch"])
def test_w8a8_matmul_rejects_what_the_kernel_does_not_take(bad):
    x, wq, sw = _int8_args()
    xq, sx = quant.quantize_int8_rows(x)
    if bad == "xq_float":
        xq = x
    elif bad == "sx_len":
        sx = sx[:3]
    elif bad == "sw_bf16":
        sw = sw.bfloat16()
    elif bad == "k_mismatch":
        wq = wq[:16].contiguous()
    with pytest.raises((ValueError, TypeError)):
        ops.w8a8_matmul(xq, sx, wq, sw)


def test_cpu_calls_take_the_plain_twins():
    x, wq, s = _int8_args()
    torch.testing.assert_close(
        ops.int8_matmul(x, wq, s), quant.int8_matmul_plain(x, wq, s), rtol=0, atol=0
    )
    xq, sx = quant.quantize_int8_rows(x)
    torch.testing.assert_close(
        ops.w8a8_matmul(xq, sx, wq, s), quant.w8a8_matmul_plain(xq, sx, wq, s),
        rtol=0, atol=0,
    )


# (K, N) of the d1024 x 12, V8192 decoder's quantised products, and the
# ragged decode shapes (M <= 8) that chip_smoke.py checks on the card
DECODER = {"qkv": (1024, 3072), "o": (1024, 1024), "fc1": (1024, 4096),
           "fc2": (4096, 1024), "head": (1024, 8192)}
RAGGED_DECODE = [(1, 1024, 3072), (5, 70, 50), (8, 33, 17), (8, 64, 48),
                 (8, 1000, 1024), (8, 17, 64), (5, 1024, 1000), (8, 4100, 1024),
                 (3, 4100, 1030), (1, 8192, 32)]


def _check_plan(m, k, n):
    """The plan's splits cover every K row and its tiles every column
    exactly once, in the tile and chunks the kernel takes (32 columns; K
    rows a multiple of 64, at most 512), with at most 16 splits, the blocks
    of one cluster, which sum their partials in shared memory: the plan
    needs no workspace in device memory.  Returns the block count."""
    tile, chunk, splits = quant._decode_plan(m, n, k)
    assert tile == 32 and chunk % 64 == 0 and 64 <= chunk <= 512
    assert 1 <= splits <= 16
    rows = np.zeros(k, np.int64)
    for s in range(splits):
        rows[s * chunk:min((s + 1) * chunk, k)] += 1
    assert (rows == 1).all() and (splits - 1) * chunk < k
    tiles = -(-n // tile)
    cols = np.zeros(tiles * tile, np.int64)
    for t in range(tiles):
        cols[t * tile:(t + 1) * tile] += 1
    assert (cols[:n] == 1).all() and (tiles - 1) * tile < n
    return tiles * splits


@pytest.mark.parametrize("name", sorted(DECODER))
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_decode_plan_fills_the_card_at_the_decoder_shapes(m, name):
    k, n = DECODER[name]
    assert _check_plan(m, k, n) >= 2 * 132


@pytest.mark.parametrize("m,k,n", RAGGED_DECODE)
def test_decode_plan_covers_ragged_shapes(m, k, n):
    _check_plan(m, k, n)


@pytest.mark.parametrize("m,k", [(0, 1024), (9, 1024), (1536, 1024), (8, 8193)])
def test_decode_plan_takes_decode_shapes_only(m, k):
    with pytest.raises(ValueError):
        quant._decode_plan(m, 1024, k)
    if m > quant.STREAM_M:  # the prefill tile, with no K split
        assert quant._plan_args(m, 1024, k) == (0, 0, quant._prefill_plan(m, 1024, k)[0])
    elif m >= 1:  # the stream, K split as its plan says
        assert quant._plan_args(m, 1024, k) == (*quant._stream_plan(m, 1024, k)[1:], 0)


# prefill-tile shapes of chip_smoke.py: the plan's tile edges at K 4096, a
# ragged K, and K past the decode path at M <= 8
RAGGED_PREFILL = [(9, 4096, 1000), (16, 4096, 1030), (100, 4096, 1000),
                  (129, 4096, 1030), (300, 4096, 1000), (1000, 4096, 1030),
                  (100, 70, 64), (40, 33, 100), (2, 9000, 48), (300, 9000, 200)]
TILES_M = (128, 64, 32)  # the prefill tiles' rows, csrc/int8_tile.cuh


def _check_prefill_plan(m, k, n):
    """The prefill tile is one the kernel has (128 columns; 128, 64 or 32
    rows) and its grid covers every output exactly once, each block
    summing over all of K.  Returns (blocks, the most any tile gives)."""
    tile_m, tile_n = quant._prefill_plan(m, n, k)
    assert tile_n == 128 and tile_m in TILES_M
    gm, gn = -(-m // tile_m), -(-n // tile_n)
    cover = np.zeros((gm * tile_m, gn * tile_n), np.int64)
    for by in range(gm):
        for bx in range(gn):
            cover[by * tile_m:(by + 1) * tile_m, bx * tile_n:(bx + 1) * tile_n] += 1
    assert (cover[:m, :n] == 1).all()
    assert (gm - 1) * tile_m < m and (gn - 1) * tile_n < n  # no empty block
    return gm * gn, max(-(-m // t) * gn for t in TILES_M)


@pytest.mark.parametrize("name", ["qkv", "o", "fc1", "fc2"])
@pytest.mark.parametrize("m", [1536, 192])
def test_prefill_plan_fills_the_card_at_the_decoder_shapes(m, name):
    k, n = DECODER[name]
    blocks, most = _check_prefill_plan(m, k, n)
    if m == 1536:  # B 8 x max_len 192: at least one block per SM
        assert blocks >= 132
    else:  # a B 1 prefill: 132 blocks or as many as the tiles allow
        assert blocks >= 132 or blocks == most


@pytest.mark.parametrize("m,k,n", RAGGED_PREFILL)
def test_prefill_plan_covers_ragged_shapes(m, k, n):
    """Each shape's plan covers it: the prefill tile's above STREAM_M rows,
    the stream's split at or below (M 2, 9, 16 and 40 of these)."""
    if quant._route(m, n, k) == "stream":
        _check_stream_plan(m, k, n)
        assert quant._plan_args(m, n, k)[2] == 0
    else:
        _check_prefill_plan(m, k, n)
        assert quant._plan_args(m, n, k)[:2] == (0, 0)


@pytest.mark.parametrize("m,k", [(1, 1024), (8, 8192), (5, 17), (0, 9000)])
def test_prefill_plan_refuses_decode_shapes(m, k):
    with pytest.raises(ValueError):
        quant._prefill_plan(m, 1024, k)
    if m >= 1:
        assert quant._plan_args(m, 1024, k)[2] == 0  # the decode kernel


# the parent's decode plan, (chunk, splits, tile_m) of the C entry, at the
# decoder's shapes (any M of 1 to 8) and the ragged decode shapes: the
# stream left every shape of the decode kernel where it was
PARENT_DECODE_PLANS = {
    "qkv": (384, 3, 0), "o": (64, 16, 0), "fc1": (384, 3, 0), "fc2": (448, 10, 0),
    "head": (512, 2, 0),
}
PARENT_RAGGED_PLANS = [
    (384, 3, 0), (64, 2, 0), (64, 1, 0), (64, 1, 0), (64, 16, 0), (64, 1, 0), (64, 16, 0),
    (512, 9, 0), (512, 9, 0), (512, 16, 0),
]


@pytest.mark.parametrize("name", sorted(DECODER))
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_decode_plan_is_the_parents_at_the_decoder_shapes(m, name):
    k, n = DECODER[name]
    assert quant._route(m, n, k) == "decode"
    assert quant._plan_args(m, n, k) == PARENT_DECODE_PLANS[name]


@pytest.mark.parametrize("i", range(len(RAGGED_DECODE)))
def test_decode_plan_is_the_parents_at_the_ragged_shapes(i):
    m, k, n = RAGGED_DECODE[i]
    assert quant._route(m, n, k) == "decode"
    assert quant._plan_args(m, n, k) == PARENT_RAGGED_PLANS[i]


# (K, N) of the Llama decoder's quantised matrices at Mistral-7B's widths,
# as chip_smoke.MISTRAL_SHAPES has them
MISTRAL = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
           "down": (14336, 4096), "head": (4096, 32000)}
# the stream's ragged shapes of chip_smoke.stream_ragged: M 9 to STREAM_M,
# and at most 8 rows with K past 8192
RAGGED_STREAM = [(9, 8193, 4096), (17, 14336, 4097), (33, 8193, 4097), (40, 16385, 50),
                 (48, 14336, 4096), (8, 14336, 50), (1, 16385, 4096), (2, 9000, 48),
                 (40, 8320, 64)]


@pytest.mark.parametrize("m", [0, 1, 8, 9, 16, 40, 63, 64, 65, 128, 384, 2048])
@pytest.mark.parametrize("k", [17, 4096, 8192, 8193, 14336])
def test_each_shape_takes_one_route(m, k):
    """_route names one route, _plan_args gives that route's plan, and
    the other two plans refuse the shape."""
    n = 4096
    if m < 1:
        for plan in (quant._decode_plan, quant._stream_plan, quant._prefill_plan):
            with pytest.raises(ValueError):
                plan(m, n, k)
        return
    route = quant._route(m, n, k)
    want = ("decode" if m <= 8 and k <= 8192 else "stream" if m <= quant.STREAM_M
            else "prefill")
    assert route == want
    plans = {"decode": quant._decode_plan, "stream": quant._stream_plan,
             "prefill": quant._prefill_plan}
    for name, plan in plans.items():
        if name == route:
            plan(m, n, k)  # takes the shape
        else:
            with pytest.raises(ValueError):
                plan(m, n, k)
    args = quant._plan_args(m, n, k)
    if route == "prefill":
        assert args == (0, 0, quant._prefill_plan(m, n, k)[0])
    else:
        assert args == (*plans[route](m, n, k)[1:], 0)


def _check_stream_plan(m, k, n):
    """The stream's splits cover every K row and its tiles every column
    exactly once, in the tile and chunks its kernel takes (128 columns; K
    rows a multiple of 32, any number of them), with at most 16 splits,
    the blocks of one cluster.  Returns the block count."""
    tile, chunk, splits = quant._stream_plan(m, n, k)
    assert tile == 128 and chunk % 32 == 0 and chunk >= 32
    assert 1 <= splits <= 16
    rows = np.zeros(splits * chunk, np.int64)
    for s in range(splits):
        rows[s * chunk:(s + 1) * chunk] += 1
    assert (rows[:k] == 1).all() and (splits - 1) * chunk < k <= splits * chunk
    tiles = -(-n // tile)
    assert (tiles - 1) * tile < n <= tiles * tile
    return tiles * splits


@pytest.mark.parametrize("m,k,n", RAGGED_STREAM)
def test_stream_plan_covers_ragged_shapes(m, k, n):
    assert quant._route(m, n, k) == "stream"
    _check_stream_plan(m, k, n)


@pytest.mark.parametrize("name", sorted(MISTRAL))
@pytest.mark.parametrize("m", [8, 40])
def test_stream_fills_the_card_at_mistrals_matrices(m, name):
    """The down projection at M 8 and all five matrices at M 40 (a verify
    forward's rows) take the stream, with at least 264 blocks."""
    k, n = MISTRAL[name]
    if m == 8 and name != "down":
        assert quant._route(m, n, k) == "decode"
        return
    assert quant._route(m, n, k) == "stream"
    assert _check_stream_plan(m, k, n) >= 2 * 132


@pytest.mark.parametrize("name", sorted(MISTRAL))
@pytest.mark.parametrize("m", ["STREAM_M + 1", 384, 1536, 2048])
def test_prefill_above_stream_m(m, name):
    m = quant.STREAM_M + 1 if m == "STREAM_M + 1" else m
    k, n = MISTRAL[name]
    assert quant._route(m, n, k) == "prefill"
    tile_m, tile_n = quant._prefill_plan(m, n, k)
    assert tile_m in TILES_M and tile_n == 128
    assert quant._plan_args(m, n, k) == (0, 0, tile_m)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax_at_a_stream_shape(x_dtype):
    """M 40, K 8320 (past the decode kernel's 8192), N 64: a shape of the
    stream, through the wrapper (its plain twin on the CPU) against the
    JAX kernel in interpret mode, f32 output."""
    m, k, n = 40, 8320, 64
    assert quant._route(m, n, k) == "stream"
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.1
    jq, js = pk.quantize_int8(jnp.asarray(w))
    tq, ts = quant.quantize_int8(torch.from_numpy(w))
    want = pk.int8_matmul(jnp.asarray(x).astype(x_dtype), jq, js, out_dtype=jnp.float32)
    got = ops.int8_matmul(torch.from_numpy(x).to(getattr(torch, x_dtype)), tq, ts,
                          out_dtype=torch.float32)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


def test_w8a8_matmul_exact_against_jax_at_a_stream_shape():
    m, k, n = 40, 8320, 64
    assert quant._route(m, n, k) == "stream"
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32)
    jxq, jsx = pk.quantize_int8_rows(jnp.asarray(x))
    jwq, jsw = pk.quantize_int8(jnp.asarray(w))
    want = pk.w8a8_matmul(jxq, jsx, jwq, jsw, out_dtype=jnp.float32)
    txq, tsx = quant.quantize_int8_rows(torch.from_numpy(x))
    twq, tsw = quant.quantize_int8(torch.from_numpy(w))
    got = ops.w8a8_matmul(txq, tsx, twq, tsw, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out", [None, "float32"])
def test_int8_matmul_plain_matches_jax_at_a_prefill_shape(out):
    m, k, n = 192, 512, 384
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.1
    jq, js = pk.quantize_int8(jnp.asarray(w))
    tq, ts = quant.quantize_int8(torch.from_numpy(w))
    want = pk.int8_matmul(jnp.asarray(x).astype(jnp.bfloat16), jq, js,
                          out_dtype=None if out is None else jnp.float32)
    got = ops.int8_matmul(torch.from_numpy(x).bfloat16(), tq, ts,
                          out_dtype=None if out is None else torch.float32)
    assert got.shape == (m, n) and str(got.dtype).endswith(str(want.dtype))
    rtol = 1e-4 if out else 2**-7  # the JAX tests' bound; bf16 out: one ulp
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=1e-3
    )


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_w8a8_matmul_plain_exact_against_jax_at_a_prefill_shape(out):
    m, k, n = 192, 512, 384
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32)
    jxq, jsx = pk.quantize_int8_rows(jnp.asarray(x))
    jwq, jsw = pk.quantize_int8(jnp.asarray(w))
    want = pk.w8a8_matmul(jxq, jsx, jwq, jsw, out_dtype=getattr(jnp, out))
    txq, tsx = quant.quantize_int8_rows(torch.from_numpy(x))
    twq, tsw = quant.quantize_int8(torch.from_numpy(w))
    got = ops.w8a8_matmul(txq, tsx, twq, tsw, out_dtype=getattr(torch, out))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _split3(x):
    """csrc/int8_tile.cuh split3 in torch: three bf16, each rounding what
    the ones before left of the f32 x."""
    b0 = x.bfloat16()
    r1 = x - b0.float()
    b1 = r1.bfloat16()
    return b0, b1, (r1 - b1.float()).bfloat16()


@pytest.mark.parametrize("span", [1, 30, 100])
def test_split3_reproduces_f32_exactly(span):
    """The three parts add up to x exactly, for exponents over +-span,
    wherever the third part is a normal bf16 (|x| >= 2^-100); below that it
    rounds to bf16's subnormal step, 2^-133, and misses x by at most half
    of it."""
    x = RNG.standard_normal(1 << 16) * np.exp2(RNG.integers(-span, span + 1, 1 << 16))
    x = torch.from_numpy(x.astype(np.float32))
    parts = _split3(x)
    total = sum(p.double() for p in parts)
    normal = x.abs() >= 2.0**-100
    assert torch.equal(total[normal], x.double()[normal])
    assert ((total - x.double()).abs() <= 2.0**-134).all()
    # each part holds what bf16 can of the rest: at most 8 significant bits
    # each, and |b1| <= ulp(b0) / 2, |b2| <= ulp(b1) / 2
    b0, b1, b2 = (p.float().abs() for p in parts)
    assert (b1 <= b0 * 2.0**-8).all() and (b2 <= b1 * 2.0**-8).all()


@pytest.mark.parametrize("span", [0, 8])
def test_f32_x_as_three_bf16_products_within_the_int8_bound(span):
    """The f32-x arithmetic of the prefill tile: x split into three bf16
    parts, each multiplied by the int8 weight widened to bf16 (exact
    products) with f32 sums, then the column scale, stays within int8's
    bound of the plain twin (rtol 1e-4, atol 1e-3, each row taken at its
    own scale; rows scaled by 2^-40 .. 2^40, elements by 2^+-span)."""
    m, k, n = 48, 512, 96
    row_exp = RNG.integers(-40, 41, (m, 1))
    x = RNG.standard_normal((m, k)) * np.exp2(RNG.integers(-span, span + 1, (m, k)))
    x = torch.from_numpy((x * np.exp2(row_exp)).astype(np.float32))
    wq, s = quant.quantize_int8(torch.from_numpy(RNG.standard_normal((k, n)).astype(np.float32)))
    wb = wq.bfloat16().float()
    assert torch.equal(wb, wq.float())  # int8 -> bf16 is exact
    acc = torch.zeros((m, n))
    for p in _split3(x):
        acc = acc + p.float() @ wb
    got, want = acc * s, quant.int8_matmul_plain(x, wq, s)
    row = torch.from_numpy(np.exp2(row_exp).astype(np.float32))
    torch.testing.assert_close(got / row, want / row, rtol=1e-4, atol=1e-3)


# The "wgmma" route of bf16-x prefill calls (quant._prefill_route): TMA must
# read both operands, so K a multiple of 8, N of 16 and both bases 16-byte
# aligned; every other prefill call keeps the mma.sync tile ("mma").
# (m, k, n, x dtype, x's offset in elements, the weight's in bytes, route)
ROUTE_CASES = (
    [(m, k, n, "bfloat16", 0, 0, "wgmma") for m in (1536, 192)
     for name, (k, n) in DECODER.items() if name != "head"]
    + [(m, k, n, "bfloat16", 0, 0, "wgmma") for m in (1536, 2048) for k, n in MISTRAL.values()]
    + [(49, 4096, 1024, "bfloat16", 0, 0, "wgmma"), (65, 1032, 1040, "bfloat16", 0, 0, "wgmma"),
       (129, 4104, 208, "bfloat16", 0, 0, "wgmma"), (300, 9000, 2064, "bfloat16", 0, 0, "wgmma"),
       (100, 8, 16, "bfloat16", 0, 0, "wgmma")]
    # chip_smoke.PREFILL_RAGGED's: N 1000 and 1030, K 70, a misaligned weight
    + [(100, 4096, 1000, "bfloat16", 0, 0, "mma"), (300, 4096, 1000, "bfloat16", 0, 0, "mma"),
       (129, 4096, 1030, "bfloat16", 0, 0, "mma"), (1000, 4096, 1030, "bfloat16", 0, 0, "mma"),
       (100, 70, 64, "bfloat16", 0, 0, "mma"), (200, 4096, 1024, "bfloat16", 0, 1, "mma"),
       (300, 9000, 200, "bfloat16", 0, 0, "mma")]
    # f32 x, and x's base 2 bytes off
    + [(1536, 1024, 3072, "float32", 0, 0, "mma"), (1536, 1024, 3072, "bfloat16", 1, 0, "mma")]
    # the stream and the decode kernel, whatever the alignment
    + [(40, 4096, 1024, "bfloat16", 0, 0, "stream"), (8, 1024, 1024, "bfloat16", 0, 0, "decode"),
       (8, 1024, 1000, "float32", 0, 1, "decode")]
)


def _operands_at(m, k, n, dtype, x_off, w_off):
    """x (m, k) and wq (k, n) whose bases lie x_off elements and w_off bytes
    past an allocation's (aligned) start: one element each, expanded, since
    the route reads only shapes, dtypes and addresses."""
    x = torch.empty(x_off + 1, dtype=getattr(torch, dtype))[x_off:].expand(m, k)
    wq = torch.empty(w_off + 1, dtype=torch.int8)[w_off:].expand(k, n)
    return x, wq


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_each_prefill_call_takes_its_route(case):
    """_int8_route refines _route's "prefill" into "wgmma" or "mma" by x's
    dtype, K % 8, N % 16 and each base's offset, and leaves the other
    routes as they are."""
    m, k, n, dtype, x_off, w_off, want = case
    x, wq = _operands_at(m, k, n, dtype, x_off, w_off)
    assert quant._int8_route(x, wq) == want
    if want in ("wgmma", "mma"):
        assert quant._route(m, n, k) == "prefill"
        assert quant._prefill_route(x, wq) == want
        tile_m, tile_n = quant._prefill_wgmma_plan(m, n, k)
        assert (tile_m, tile_n) in quant._WGMMA_TILES
    else:
        assert quant._route(m, n, k) == want


_TILE_SRC = (Path(quant.__file__).resolve().parent.parent / "csrc" / "int8_tile.cuh").read_text()
_WGP_SRC = _TILE_SRC[_TILE_SRC.index("namespace wgp {"):_TILE_SRC.index("}  // namespace wgp")]


def _wgp_constant(name):
    return int(re.search(rf"{name} = (\d+)", _WGP_SRC).group(1))


def _wgmma_smem(tile_m, tile_n):
    """Shared memory of a wgmma tile's block, by csrc/int8_tile.cuh
    wgp::smem_bytes with the constants read from the source: 1024 bytes of
    alignment, the ring's stages and two mbarriers a stage."""
    ring, most = _wgp_constant("RING_BYTES"), _wgp_constant("MAX_STAGES")
    stage = tile_m * 64 * 2 + tile_n // 128 * 64 * 128
    stages = min(most, ring // stage)
    return 1024 + stages * stage + 2 * stages * 8, stages


def test_wgmma_tiles_are_the_kernels():
    """The plan's tiles are those launch_prefill_wgmma takes, each 128
    columns a weight box, and each block's ring fits the H100's 227 KB of
    shared memory with at least 4 stages."""
    cases = re.findall(r"case (\d+)(\d{3}): return launch_prefill_wgmma_tile<(\d+), (\d)>",
                       _TILE_SRC)
    tiles = {(int(a), int(b)) for a, b, _, _ in cases}
    assert tiles == set(quant._WGMMA_TILES)
    for a, b, bm, nh in cases:
        assert int(a) == int(bm) and int(b) == 128 * int(nh)
    for tile in quant._WGMMA_TILES:
        smem, stages = _wgmma_smem(*tile)
        assert smem <= 232448 and stages >= 4


WGMMA_PLAN_SHAPES = (
    [(m, *DECODER[name]) for m in (1536, 192) for name in ("qkv", "o", "fc1", "fc2")]
    + [(m, k, n) for m in (1536, 2048) for k, n in MISTRAL.values()]
    + [(m, 4096, 1024) for m in (49, 65, 129, 1000)]
)


def _wgmma_block_tiles(m, n, k, tile_m, tile_n, x_bytes=2):
    """(row tile, column tile) of each block of the wgmma kernel's 1-D
    grid, as int8_prefill_wgmma orders them: row tiles in groups of as many
    as GROUP_BYTES of x (x_bytes an element) holds
    (launch_prefill_wgmma_tile), the row tile fastest within a group."""
    tiles_m, tiles_n = -(-m // tile_m), -(-n // tile_n)
    group = min(max(_wgp_constant("GROUP_BYTES") // (x_bytes * tile_m * k), 1), tiles_m)
    b = np.arange(tiles_m * tiles_n)
    first = b // (group * tiles_n) * group
    rows = np.minimum(group, tiles_m - first)
    r = b % (group * tiles_n)
    return first + r % rows, r // rows


@pytest.mark.parametrize("m,k,n", WGMMA_PLAN_SHAPES)
def test_wgmma_plan_covers_every_output_once(m, k, n):
    """The wgmma plan's grid covers every row and column exactly once, with
    no empty block (the kernel sums each output over all of K): its blocks
    take every (row tile, column tile) once, and the tiles cover the rows
    and the columns; it takes the tile whose waves of 132 blocks cost
    least by the fitted block times."""
    tile_m, tile_n = quant._prefill_wgmma_plan(m, n, k)
    tm, tn = _wgmma_block_tiles(m, n, k, tile_m, tile_n)
    tiles_m, tiles_n = -(-m // tile_m), -(-n // tile_n)
    assert sorted(zip(tm.tolist(), tn.tolist())) == [
        (i, j) for i in range(tiles_m) for j in range(tiles_n)]
    for size, tile in ((m, tile_m), (n, tile_n)):
        blocks = -(-size // tile)
        cover = np.zeros(blocks * tile, np.int64)
        for b in range(blocks):
            cover[b * tile:(b + 1) * tile] += 1
        assert (cover[:size] == 1).all() and (blocks - 1) * tile < size
    costs = {t: -(-(-(-m // t[0]) * -(-n // t[1])) // 132) * (a + b * k)
             for t, (a, b) in quant._WGMMA_TILES.items()}
    assert costs[(tile_m, tile_n)] == min(costs.values())


def _wgmma_model(x, wq, s, tile_m, tile_n, out_dtype):
    """The wgmma tile's order of sums in torch: each output tile (tile_m
    rows by tile_n columns, zero-padded past M, N and K) sums f32 products
    of 16-deep K steps in order from zero, the int8 weight widened exactly;
    the column scale multiplies each sum once, after the whole K sum."""
    m, k = x.shape
    n = wq.shape[1]
    kp = -(-k // 64) * 64  # whole stages of 64 rows, zeros past K
    mp, np_ = -(-m // tile_m) * tile_m, -(-n // tile_n) * tile_n
    xp = torch.zeros((mp, kp))
    xp[:m, :k] = x.float()
    wp = torch.zeros((kp, np_))
    wp[:k, :n] = wq.float()
    sp = torch.zeros(np_)
    sp[:n] = s
    out = torch.empty((mp, np_), dtype=out_dtype)
    for r0 in range(0, mp, tile_m):
        for c0 in range(0, np_, tile_n):
            acc = torch.zeros((tile_m, tile_n))
            for k0 in range(0, kp, 16):
                acc = acc + xp[r0:r0 + tile_m, k0:k0 + 16] @ wp[k0:k0 + 16, c0:c0 + tile_n]
            out[r0:r0 + tile_m, c0:c0 + tile_n] = (acc * sp[c0:c0 + tile_n]).to(out_dtype)
    return out[:m, :n]


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_wgmma_order_of_sums_matches_jax(out):
    """M 100, K 200, N 144: a partial last K step (200 = 12 x 16 + 8), a
    partial last row and column tile, on the wgmma route; the model of
    the kernel's sums at each of its tiles against the JAX kernel in
    interpret mode, within test_int8_matmul_plain_matches_jax_at_a_
    prefill_shape's bound (rtol 1e-4 for f32 out, one bf16 ulp for bf16;
    atol 1e-3), and against the plain twin."""
    m, k, n = 100, 200, 144
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.1
    jq, js = pk.quantize_int8(jnp.asarray(w))
    tq, ts = quant.quantize_int8(torch.from_numpy(w))
    xb = torch.from_numpy(x).bfloat16()
    assert quant._int8_route(xb, tq) == "wgmma"
    want = np.asarray(pk.int8_matmul(jnp.asarray(x).astype(jnp.bfloat16), jq, js,
                                     out_dtype=getattr(jnp, out)), np.float32)
    plain = quant.int8_matmul_plain(xb, tq, ts, getattr(torch, out)).float().numpy()
    rtol = 1e-4 if out == "float32" else 2**-7
    for tile in quant._WGMMA_TILES:
        got = _wgmma_model(xb, tq, ts, *tile, getattr(torch, out)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-3)
        np.testing.assert_allclose(got, plain, rtol=rtol, atol=1e-3)


# w8a8_matmul's prefill routes (quant._w8a8_prefill_route): the s8 wgmma
# tile where TMA can read both operands (K a multiple of 16, xq's row
# stride in bytes; N of 16; both bases 16-byte aligned), else the mma.sync
# tile.  (m, k, n, xq's offset in bytes, the weight's, w8a8's route, the
# route int8_matmul's own rule gives bf16 x at that shape and offset)
W8A8_ROUTE_CASES = (
    [(m, k, n, 0, 0, "wgmma", "wgmma") for m in (1536, 192)
     for name, (k, n) in DECODER.items() if name != "head"]
    + [(m, k, n, 0, 0, "wgmma", "wgmma") for m in (1536, 2048) for k, n in MISTRAL.values()]
    # chip_smoke.W8A8_RAGGED: ragged M, K a multiple of 16 but not of 128,
    # N not of 128 or 256, K 16
    + [(49, 4096, 1024, 0, 0, "wgmma", "wgmma"), (65, 1040, 1040, 0, 0, "wgmma", "wgmma"),
       (129, 4112, 208, 0, 0, "wgmma", "wgmma"), (1000, 4096, 1040, 0, 0, "wgmma", "wgmma"),
       (300, 9008, 2064, 0, 0, "wgmma", "wgmma"), (100, 16, 16, 0, 0, "wgmma", "wgmma")]
    # K a multiple of 8 but not of 16: int8's bf16 rows are whole 16 bytes,
    # xq's are not
    + [(65, 1032, 1040, 0, 0, "mma", "wgmma"), (100, 8, 16, 0, 0, "mma", "wgmma"),
       (300, 9000, 2064, 0, 0, "mma", "wgmma")]
    # N not a multiple of 16; bases off a 16-byte boundary
    + [(300, 4096, 1000, 0, 0, "mma", "mma"), (129, 4096, 1030, 0, 0, "mma", "mma"),
       (200, 4096, 1024, 0, 1, "mma", "mma"), (200, 4096, 1024, 8, 0, "mma", "mma"),
       (200, 4096, 1024, 1, 0, "mma", "mma"), (200, 4096, 1024, 16, 16, "wgmma", "wgmma")]
    # M at and past STREAM_M, and decode rows, whatever the widths
    + [(48, 4096, 1024, 0, 0, "stream", "stream"), (49, 4096, 1024, 0, 0, "wgmma", "wgmma"),
       (48, 1032, 1000, 0, 1, "stream", "stream"), (8, 1024, 1024, 0, 0, "decode", "decode"),
       (8, 14336, 4096, 0, 0, "stream", "stream")]
)


@pytest.mark.parametrize("case", W8A8_ROUTE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_each_w8a8_prefill_call_takes_its_route(case):
    """_w8a8_route refines _route's "prefill" by w8a8's own rule (K % 16,
    N % 16, each base's offset), and int8_matmul's _int8_route by its own
    (bf16 x: K % 8): neither wrapper's route is read from the other's."""
    m, k, n, x_off, w_off, want, want_int8 = case
    xq = torch.empty(x_off + 1, dtype=torch.int8)[x_off:].expand(m, k)
    wq = torch.empty(w_off + 1, dtype=torch.int8)[w_off:].expand(k, n)
    assert quant._w8a8_route(xq, wq) == want
    x = torch.empty(x_off // 2 + 1, dtype=torch.bfloat16)[x_off // 2:].expand(m, k)
    if x_off % 2 == 0:
        assert quant._int8_route(x, wq) == want_int8
    if want in ("wgmma", "mma"):
        assert quant._route(m, n, k) == "prefill"
        assert quant._w8a8_prefill_route(xq, wq) == want
        assert quant._w8a8_wgmma_plan(m, n, k) in quant._W8A8_TILES
        plan = quant._launch_plan(want, m, n, k, quant._w8a8_wgmma_plan)
        assert plan == ((0, 0, *quant._w8a8_wgmma_plan(m, n, k)) if want == "wgmma"
                        else (0, 0, quant._prefill_plan(m, n, k)[0], 0))
    else:
        assert quant._route(m, n, k) == want


def _s8_stage(tile_m, tile_n):
    """A w8a8 wgmma block's stage bytes and stages, by csrc/int8_tile.cuh
    wgp:: with the constants read from the source: x's box (tile_m rows of
    128 bytes) and tile_n / 128 weight boxes of bk() K rows of 128 bytes
    (bk() is 128 s8 rows), as many stages as RING_BYTES holds, at most
    MAX_STAGES."""
    bk = int(re.search(r"bk\(\) \{ return (\d+) / \(int\)sizeof\(XT\)", _WGP_SRC).group(1))
    stage = tile_m * 128 + tile_n // 128 * bk * 128
    return stage, min(_wgp_constant("MAX_STAGES"), _wgp_constant("RING_BYTES") // stage)


def test_w8a8_wgmma_tiles_are_the_kernels():
    """w8a8's plan takes only tiles that launch_prefill_wgmma takes, the
    tiles int8's plan takes, and each block's ring of s8 stages (128 K rows
    a stage) fits the H100's 227 KB of shared memory with at least 4
    stages; a block of s8 costs less a K row than one of bf16."""
    cases = re.findall(r"case (\d+)(\d{3}): return launch_prefill_wgmma_tile<(\d+), (\d)>",
                       _TILE_SRC)
    assert {(int(a), int(b)) for a, b, _, _ in cases} == set(quant._W8A8_TILES)
    assert set(quant._W8A8_TILES) == set(quant._WGMMA_TILES)
    for tile, (a, b) in quant._W8A8_TILES.items():
        stage, stages = _s8_stage(*tile)
        assert 1024 + stages * stage + 2 * stages * 8 <= 232448 and stages >= 4
        assert a > 0 and 0 < b < quant._WGMMA_TILES[tile][1]


W8A8_PLAN_SHAPES = (
    [(m, *DECODER[name]) for m in (1536, 192) for name in ("qkv", "o", "fc1", "fc2")]
    + [(m, k, n) for m in (1536, 2048) for k, n in MISTRAL.values()]
    + [(49, 4096, 1024), (65, 1040, 1040), (129, 4112, 208), (1000, 4096, 1040),
       (300, 9008, 2064), (100, 16, 16)]
)


@pytest.mark.parametrize("m,k,n", W8A8_PLAN_SHAPES)
def test_w8a8_wgmma_plan_covers_every_output_once(m, k, n):
    """The w8a8 plan's grid, in the kernel's launch order (a group holds
    twice bf16's rows: x is one byte an element), takes every (row tile,
    column tile) once, its tiles cover the rows and columns once, and it
    takes the tile whose waves of 132 blocks cost least by _W8A8_TILES."""
    tile_m, tile_n = quant._w8a8_wgmma_plan(m, n, k)
    tm, tn = _wgmma_block_tiles(m, n, k, tile_m, tile_n, x_bytes=1)
    tiles_m, tiles_n = -(-m // tile_m), -(-n // tile_n)
    assert sorted(zip(tm.tolist(), tn.tolist())) == [
        (i, j) for i in range(tiles_m) for j in range(tiles_n)]
    for size, tile in ((m, tile_m), (n, tile_n)):
        assert (-(-size // tile) - 1) * tile < size <= -(-size // tile) * tile
    costs = {t: -(-(-(-m // t[0]) * -(-n // t[1])) // 132) * (a + b * k)
             for t, (a, b) in quant._W8A8_TILES.items()}
    assert costs[(tile_m, tile_n)] == min(costs.values())


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte j of the result is byte
    (sel >> 4 j) & 7 of the 8 bytes (x low, y high)."""
    b = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                 + [(y >> (8 * i)) & 0xFF for i in range(4)])
    sel = np.broadcast_to(np.asarray(sel, np.uint32), x.shape)
    cols = np.arange(x.shape[0])
    out = np.zeros_like(x)
    for j in range(4):
        out |= b[(sel >> (4 * j)) & 7, cols] << (8 * j)
    return out


def _swizzled(r, col):
    """Byte col of row r of a 128-byte-swizzled box: csrc/int8_tile.cuh
    wgp::swizzled."""
    return r * 128 + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15))


def _rotated_sel(q, c):
    """wgp::rotated_sel: byte j of column c' is row (j - q) & 3."""
    s = np.zeros_like(q, dtype=np.uint32)
    for j in range(4):
        i = (j - q) & 3
        s |= (np.where(i < 2, 0, 4) + 2 * c + (i & 1)).astype(np.uint32) << (4 * j)
    return s


def _tma_box(src, r0, c0, rows, cols=128):
    """The bytes a 2-D TMA load of a (rows, 128) box at (r0, c0) writes
    under the 128-byte swizzle, zeros outside src: row r's 16-byte chunk c
    at chunk c ^ (r % 8)."""
    box = np.zeros((rows, cols), np.uint8)
    part = src[r0:r0 + rows, c0:c0 + cols]
    box[:part.shape[0], :part.shape[1]] = part
    out = np.zeros(rows * 128, np.uint8)
    r = np.arange(rows)[:, None]
    b = np.arange(128)[None, :]
    out[_swizzled(r, b)] = box
    return out


def _w8a8_wgmma_model(xq, sx, wq, sw, tile_m, tile_n, out_dtype):
    """w8a8's s8 wgmma tile, thread by thread, in numpy: each block's
    stages as TMA writes them (x's (tile_m, 128) box and tile_n / 128
    weight boxes of 128 K rows, swizzled, zeros past M, N and K); each
    consumer thread's A fragments as the kernel reads them (wgp::Fragments
    <int8_t, NH>: rows staggered at NH 1 and in plain order at NH 2, the
    transpose's selectors rotated to match); the register A
    operand assembled by PTX's m64nNk32 s8 layout and B read through the
    descriptor's swizzle; exact sums; each thread's accumulators by PTX's
    layout, stored where the kernel's epilogue stores them, as float(acc) *
    sx[m] * sw[n] in f32.  Fails unless every output is stored once."""
    m, k = xq.shape
    n = wq.shape[1]
    nh = tile_n // 128
    x8, w8 = xq.numpy().view(np.uint8), wq.numpy().view(np.uint8)
    out = np.zeros((m, n), np.float64)
    stored = np.zeros((m, n), np.int64)
    t = np.arange(256)  # the two consumer warpgroups' threads
    c, w, g, q = t // 128, t // 32 % 4, t % 32 // 4, t % 4
    col = 64 * c + 16 * w + 2 * g if nh == 1 else 32 * w + 4 * g
    box = np.zeros_like(c) if nh == 1 else c
    rot = q if nh == 1 else np.zeros_like(q)  # Fragments::STAGGER: NH 1 only
    offs = [_swizzled(4 * q + ((i + rot) & 3), col) for i in range(4)]
    sel = [_rotated_sel(rot, 0), _rotated_sel(rot, 1)]
    width = 2 if nh == 1 else 4  # bytes a thread reads a row
    for m0 in range(0, m, tile_m):
        for n0 in range(0, n, tile_n):
            acc = np.zeros((2, nh, 64, tile_m), np.int64)  # consumer, product, A row, x row
            for k0 in range(0, k, 128):
                xbox = _tma_box(x8, m0, k0, tile_m)
                wboxes = [_tma_box(w8, k0, n0 + 128 * h, 128) for h in range(nh)]
                wsrc = np.stack([wboxes[b] for b in box])  # each thread's box
                for kk in range(4):  # k32 steps
                    a = np.zeros((nh, 4, 256), np.uint32)
                    for half in range(2):
                        r = []
                        for i in range(4):
                            o = offs[i] + 2048 * half + 4096 * kk
                            r.append(sum(wsrc[t, o + j].astype(np.uint32) << (8 * j)
                                         for j in range(width)))
                        t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
                        t2, t3 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
                        cols = [_byte_perm(t0, t2, sel[0]), _byte_perm(t0, t2, sel[1]),
                                _byte_perm(t1, t3, sel[0]), _byte_perm(t1, t3, sel[1])]
                        for h in range(nh):
                            a[h, 2 * half], a[h, 2 * half + 1] = cols[2 * h], cols[2 * h + 1]
                    # B (x rows, 32 K) through the K-major 128-byte-swizzle descriptor
                    rr = np.arange(tile_m)[:, None]
                    kb = 32 * kk + np.arange(32)[None, :]
                    b = xbox[rr * 128 + (((kb >> 4) ^ (rr & 7)) << 4) + (kb & 15)]
                    b = b.view(np.int8).astype(np.int64)
                    for cc in range(2):
                        th = t[c == cc]
                        for h in range(nh):
                            amat = np.zeros((64, 32), np.int64)
                            for reg in range(4):
                                for byte in range(4):
                                    v = ((a[h, reg, th] >> (8 * byte)) & 0xFF).astype(np.uint8)
                                    amat[16 * w[th] + g[th] + 8 * (reg & 1),
                                         4 * q[th] + byte + 16 * (reg >> 1)] = v.view(np.int8)
                            acc[cc, h] += amat @ b.T
            for cc in range(2):
                th = t[c == cc]
                for h in range(nh):
                    for j in range(tile_m // 8):
                        for e in range(2):
                            rows = m0 + 8 * j + 2 * q[th] + e
                            for half in range(2):  # A rows g and g + 8: columns 2 h, 2 h + 1
                                v = acc[cc, h, 16 * w[th] + g[th] + 8 * half, 8 * j + 2 * q[th] + e]
                                cols = n0 + 128 * box[th] + col[th] + 2 * h + half
                                ok = (rows < m) & (n0 + 128 * box[th] + col[th] < n)
                                out[rows[ok], cols[ok]] = v[ok]
                                stored[rows[ok], cols[ok]] += 1
    assert (stored == 1).all()
    acc32 = torch.from_numpy(out).float()  # |sums| < 2^24 here: exact
    return (acc32 * sx[:, None] * sw).to(out_dtype)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_w8a8_wgmma_model_bitwise_jax_and_twin(out):
    """M 100, K 272, N 144: a partial last K stage (272 = 2 x 128 + 16), a
    partial last row and column tile, on w8a8's wgmma route; the model of
    the kernel's data movement (w8a8_wgmma_model) at each of its tiles (NH
    1 and 2) bitwise equal to the JAX kernel in interpret mode and to the
    plain twin."""
    m, k, n = 100, 272, 144
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32)
    jxq, jsx = pk.quantize_int8_rows(jnp.asarray(x))
    jwq, jsw = pk.quantize_int8(jnp.asarray(w))
    want = np.asarray(pk.w8a8_matmul(jxq, jsx, jwq, jsw, out_dtype=getattr(jnp, out)),
                      np.float32)
    xq, sx = quant.quantize_int8_rows(torch.from_numpy(x))
    wq, sw = quant.quantize_int8(torch.from_numpy(w))
    assert quant._w8a8_route(xq, wq) == "wgmma"
    odt = getattr(torch, out)
    plain = quant.w8a8_matmul_plain(xq, sx, wq, sw, odt).float().numpy()
    np.testing.assert_array_equal(plain, want)
    for tile in quant._W8A8_TILES:
        got = _w8a8_wgmma_model(xq, sx, wq, sw, *tile, odt)
        assert got.dtype == odt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_rotated_transpose_is_transpose4():
    """At every lane q, the rotated reads and selectors give transpose4's
    columns; at q 0 the selectors are transpose4's own."""
    rows = RNG.integers(0, 2**32, (4, 64), dtype=np.uint64).astype(np.uint32)
    assert _rotated_sel(np.zeros(1, np.int64), 0)[0] == 0x5410
    assert _rotated_sel(np.zeros(1, np.int64), 1)[0] == 0x7632
    for lane_q in range(4):
        qq = np.full(64, lane_q)
        r = [rows[(i + lane_q) & 3] for i in range(4)]
        t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
        t2, t3 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
        s0, s1 = _rotated_sel(qq, 0), _rotated_sel(qq, 1)
        got = [_byte_perm(t0, t2, s0), _byte_perm(t0, t2, s1),
               _byte_perm(t1, t3, s0), _byte_perm(t1, t3, s1)]
        for j in range(4):  # column j: byte j of each row, row 0 lowest
            want = sum(((rows[i] >> (8 * j)) & 0xFF) << (8 * i) for i in range(4))
            np.testing.assert_array_equal(got[j], want)


def test_w8a8_on_the_cpu_takes_the_twin_and_counts_no_route():
    """On CPU tensors w8a8_matmul at a prefill shape its wgmma route would
    take returns the plain twin's bits and counts no launch and no route."""
    xq, sx = quant.quantize_int8_rows(torch.from_numpy(
        RNG.standard_normal((64, 32)).astype(np.float32)))
    wq, sw = quant.quantize_int8(torch.from_numpy(RNG.standard_normal((32, 16)).astype(np.float32)))
    assert quant._w8a8_route(xq, wq) == "wgmma"
    before = dict(ops.w8a8_matmul.routes)
    got = ops.w8a8_matmul(xq, sx, wq, sw, out_dtype=torch.bfloat16)
    assert torch.equal(got, quant.w8a8_matmul_plain(xq, sx, wq, sw, torch.bfloat16))
    assert ops.w8a8_matmul.routes == before and ops.w8a8_matmul.launches == 0
