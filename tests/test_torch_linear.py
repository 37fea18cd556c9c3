"""The eager f32 ``use_pallas`` route of the port against the JAX package's:
the plain twins of ``ops.matmul`` and ``ops.linear_fused``
(deepflows_tpu_torch/ops/linear.py) against the Pallas ``matmul`` and
``linear_fused`` (interpret mode on the CPU), ``nn.functional.linear``'s
two routes against the JAX package's eager ``config.use_pallas`` path,
``F.relu``'s tie, an eager ``models.MLP`` Adam trajectory, the route
switched off inside the whole steps, and the kernel's tiling plan
(``_linear_plan``) at the MLP's products.

Inputs are numpy arrays from seeds; models start from the JAX weights.
Tolerances: the twins rtol 1e-5 / atol 1e-4 against the kernels (the same
products summed in other orders, K up to 384 of unit normals); the
routes' outputs and gradients rtol 1e-5 / atol 1e-5; the 5-step MLP
trajectory's losses and final weights within 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.ops import pallas_kernels as pk
from deepflows_tpu_torch import config as tconfig
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep
from deepflows_tpu_torch.models import MLP
from deepflows_tpu_torch.nn import functional as F
from deepflows_tpu_torch.ops import linear
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(61)
TOL = dict(rtol=1e-5, atol=1e-4)
ROUTE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state and both packages'
    ``use_pallas`` as this module found them."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = config.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    pallas = (config.use_pallas, tconfig.use_pallas)
    yield
    config.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager
    config.use_pallas, tconfig.use_pallas = pallas


@pytest.fixture(autouse=True)
def _clean():
    from deepflows_tpu import config

    ops.reset_launch_counts()
    yield
    config.use_pallas = tconfig.use_pallas = False
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _use_pallas(on: bool):
    from deepflows_tpu import config

    config.use_pallas = tconfig.use_pallas = on


def _normal(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (100, 70, 50), (257, 129, 384), (64, 100, 32)])
def test_matmul_matches_jax_kernel(m, k, n):
    a, b = _normal(m, k), _normal(k, n)
    want = np.asarray(pk.matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ops.matmul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               want, **TOL)
    # the wrapper, on operands seen through a transpose
    at = torch.from_numpy(a.T.copy()).t()
    bt = torch.from_numpy(b.T.copy()).t()
    assert not at.is_contiguous() and not bt.is_contiguous()
    np.testing.assert_allclose(ops.matmul(at, bt).numpy(), want, **TOL)


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("m,k,n", [(64, 100, 32), (100, 70, 50), (257, 129, 384)])
def test_linear_fused_matches_jax_kernel(m, k, n, act):
    x, w, b = _normal(m, k), _normal(k, n), _normal(1, n)
    want = np.asarray(pk.linear_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act))
    got = ops.linear_fused_plain(*(torch.from_numpy(t) for t in (x, w, b)), act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = ops.linear_fused(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b.reshape(-1)), act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_check_their_operands():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        ops.matmul(a, torch.zeros(4, 3))
    with pytest.raises(TypeError):
        ops.matmul(a.double(), torch.zeros(3, 2))
    with pytest.raises(ValueError, match="activation"):
        ops.linear_fused(a, torch.zeros(3, 2), torch.zeros(2), "gelu")
    with pytest.raises(ValueError):
        ops.linear_fused(a, torch.zeros(3, 2), torch.zeros(3))


# every product of the eager MLP (784-100-20-10, B 256) as (M, K, N): the
# three layers, then the bias-free twin's backward dW = x^T g and dx = g W^T
MLP_PRODUCTS = [(256, 784, 100), (256, 100, 20), (256, 20, 10),
                (784, 256, 100), (100, 256, 20), (20, 256, 10), (256, 20, 100), (256, 10, 20)]


def _check_linear_plan(m, k, n):
    """The plan's tile is one csrc/linear_f32.cu has, and its K splits cover
    every K row exactly once: all of K on the 128 x 256 tile, chunks that
    are multiples of 8 and at least 16 rows on the 32 x 32 tile (or all of
    a smaller K), at most 16 splits (the blocks of one cluster).  Returns
    (blocks, the most blocks the small tile can give: its finest split,
    the smallest chunk over at most 16 splits)."""
    tile, chunk, splits = linear._linear_plan(m, n, k)
    assert tile in (128, 32) and 1 <= splits <= 16
    rows = np.zeros(k, np.int64)
    for s in range(splits):
        rows[s * chunk:min((s + 1) * chunk, k)] += 1
    assert (rows == 1).all() and (splits - 1) * chunk < k
    if tile == 128:
        assert (chunk, splits) == (k, 1)
    else:
        assert chunk % 8 == 0 and (chunk >= 16 or splits == 1)
    finest = -(-k // max(16, 8 * -(-k // 128)))
    cols = linear._LARGE_N if tile == 128 else tile
    return -(-m // tile) * -(-n // cols) * splits, -(-m // 32) * -(-n // 32) * finest


@pytest.mark.parametrize("m,k,n", MLP_PRODUCTS)
def test_linear_plan_fills_the_card_at_the_mlp_products(m, k, n):
    """132 blocks (one an SM) wherever the 16 splits allow it; where K or
    M·N is too small for that, the finest split."""
    blocks, most = _check_linear_plan(m, k, n)
    assert blocks >= 132 or blocks == most


@pytest.mark.parametrize("m,k,n", [(64, 8, 48), (64, 9, 48), (64, 16, 48), (64, 17, 48),
                                   (64, 784, 48), (64, 4095, 48), (1, 5, 3), (257, 129, 384),
                                   (4096, 4096, 4096)])
def test_linear_plan_covers_k_once(m, k, n):
    blocks, most = _check_linear_plan(m, k, n)
    if m == 4096:  # a grid of 512 large tiles keeps the large tile
        assert linear._linear_plan(m, n, k) == (128, k, 1)
    else:
        assert blocks >= 132 or blocks == most


def _tile_constants(namespace):
    """{name: value} of the ``constexpr int`` lines that open ``namespace``
    in csrc/linear_f32.cu."""
    import re
    from pathlib import Path

    src = (Path(linear.__file__).parent.parent / "csrc" / "linear_f32.cu").read_text()
    body = src[src.index(f"namespace {namespace} {{"):]
    body = body[:body.index("__device__") if "__device__" in body[:2000] else 2000]
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", " ".join(
        line for line in body.splitlines() if line.startswith("constexpr int")))}


def test_linear_plan_constants_are_the_kernels():
    """The plan's tiles, K multiple and most splits are those the kernel
    declares: the large tile 128 x 16·TN (K stages of 32, a ring of 4),
    the small one 32 x 32 with at most 16 K splits."""
    large, small = _tile_constants("large"), _tile_constants("small")
    assert (large["BM"], 16 * large["TN"]) == (linear._LARGE, linear._LARGE_N)
    assert (large["BK"], large["STAGES"], large["MIN_BLOCKS"]) == (32, 4, 1)
    assert small["BM"] == small["BN"] == linear._SMALL
    assert small["MAX_SPLITS"] == linear._MAX_SPLITS and linear._SMS == 132


# (M, K, N, tile): the large tile takes a product whose grid of large tiles
# has at least 132 blocks (11 x 12 here at the edge), the small tile the
# rest; chip_smoke.py's ragged large-tile shapes
_LN = linear._LARGE_N


@pytest.mark.parametrize("m,k,n,tile", [(1408, 64, 12 * _LN, 128), (1408, 64, 11 * _LN + 1, 128),
                                        (1408, 64, 11 * _LN, 32), (1281, 64, 12 * _LN, 128),
                                        (1280, 64, 12 * _LN, 32), (2000, 1032, 2056, 128),
                                        (2000, 1030, 2050, 128),
                                        (1536, 100, 2817, 128), (1500, 1001, 2900, 128)])
def test_linear_plan_takes_the_large_tile_where_it_fills_the_card(m, k, n, tile):
    assert linear._linear_plan(m, n, k)[0] == tile
    blocks, most = _check_linear_plan(m, k, n)
    assert blocks >= 132 or blocks == most


@pytest.mark.parametrize("bias", [True, False])
def test_functional_linear_route_matches_jax(bias):
    """F.linear under use_pallas against the JAX package's eager route: the
    fused op with a bias, the Pallas matmul (forward and both backward
    products) without one."""
    df.manual_seed(4)
    jlin = jnn.Linear(100, 32, bias=bias, device="tpu")
    tlin = tnn.Linear(100, 32, bias=bias, device="cpu")
    load_jax_state_dict(tlin, jlin.state_dict())
    x, gout = _normal(16, 100), _normal(16, 32)
    _use_pallas(True)
    tx = Tensor(x, device="tpu", requires_grad=True)
    jout = jlin(tx)
    (jout * Tensor(gout, device="tpu")).sum().backward()
    want = [jout.numpy(), tx.grad.numpy(), jlin.weight.grad.numpy()]
    if bias:
        want.append(jlin.bias.grad.numpy())
    px = torch.from_numpy(x).requires_grad_()
    out = tlin(px)
    assert type(out.grad_fn).__name__ == ("_FusedLinearBackward" if bias else "_MatmulBackward")
    (out * torch.from_numpy(gout)).sum().backward()
    got = [out.detach(), px.grad, tlin.weight.grad] + ([tlin.bias.grad] if bias else [])
    for g, w, name in zip(got, want, ("out", "dx", "dw", "db")):
        np.testing.assert_allclose(g.numpy(), w, **ROUTE_TOL, err_msg=name)
    if bias:
        assert tlin.bias.grad.shape == (1, 32)
    _use_pallas(False)
    assert type(tlin(px).grad_fn).__name__ != "_FusedLinearBackward"


def test_relu_splits_the_tie_like_jax():
    x = np.asarray([-1.0, 0.0, 2.0], np.float32)
    jx = Tensor(x, device="tpu", requires_grad=True)
    jnn.functional.relu(jx).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    F.relu(tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())
    np.testing.assert_array_equal(tx.grad.numpy(), [0.0, 0.5, 1.0])
    assert torch.equal(tnn.Tanh()(tx), torch.tanh(tx))


def _mnist_like(steps, b):
    r = np.random.default_rng(7)
    teacher = r.standard_normal((784, 10)).astype(np.float32)
    xs = r.random((steps, b, 784), dtype=np.float32)
    return xs, (xs @ teacher).argmax(-1).astype(np.int32)


def test_mlp_eager_trajectory_matches_jax():
    """Five eager Adam steps of models.MLP under use_pallas, the port's
    twins against the JAX package's Pallas kernels."""
    xs, ys = _mnist_like(5, 32)
    df.manual_seed(0)
    jm = jmodels.MLP(device="tpu")
    tm = MLP(device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    _use_pallas(True)
    jopt, topt = joptim.Adam(jm.parameters(), lr=1e-3), optim.Adam(tm.parameters(), lr=1e-3)
    jcrit, tcrit = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    want, got = [], []
    for x, y in zip(xs, ys):
        loss = jcrit(jm(Tensor(x, device="tpu")), Tensor(y, device="tpu"))
        jopt.zero_grad()
        loss.backward()
        jopt.step()
        want.append(float(loss.numpy()))
        out = tm(torch.from_numpy(x))
        assert type(out.grad_fn).__name__ == "_FusedLinearBackward"
        loss = tcrit(out, torch.from_numpy(y))
        topt.zero_grad()
        loss.backward()
        topt.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jm.state_dict()[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_route_is_off_inside_whole_steps(monkeypatch):
    """CompiledTrainStep and CompiledEvalStep never take the eager route,
    as the JAX package's traced steps never do; the switch is restored."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return ops.linear_fused(*args, **kwargs)

    monkeypatch.setattr(F, "linear_fused", counting)
    xs, ys = _mnist_like(1, 8)
    x, y = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    model = MLP(device="cpu")
    _use_pallas(True)
    model(x)
    assert len(calls) == 3
    step = CompiledTrainStep(model, optim.Adam(model.parameters()), tnn.CrossEntropyLoss())
    step(x, y)
    CompiledEvalStep(model)(x)
    assert len(calls) == 3 and tconfig.use_pallas
