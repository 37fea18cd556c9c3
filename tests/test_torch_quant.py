"""The port's int8 kernels' plain twins (deepflows_tpu_torch/ops/quant.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

Inputs are numpy arrays from a seed, handed to both packages.  Tolerances:
quantisation and w8a8 are bit-exact (integer sums, then the same f32 ops in
the same order); int8_matmul uses tests/test_pallas.py's rtol 1e-4 and atol
1e-3, since the f32 sums run in another order.  On CPU tensors the wrappers
take the plain twins and never count a launch.
"""

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
    if m > 8 or k > 8192:  # the prefill tile, with no K split
        assert quant._plan_args(m, 1024, k) == (0, 0, quant._prefill_plan(m, 1024, k)[0])


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
    _check_prefill_plan(m, k, n)
    assert quant._plan_args(m, n, k)[:2] == (0, 0)


@pytest.mark.parametrize("m,k", [(1, 1024), (8, 8192), (5, 17), (0, 9000)])
def test_prefill_plan_refuses_decode_shapes(m, k):
    with pytest.raises(ValueError):
        quant._prefill_plan(m, 1024, k)
    if m >= 1:
        assert quant._plan_args(m, 1024, k)[2] == 0  # the decode kernel


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
