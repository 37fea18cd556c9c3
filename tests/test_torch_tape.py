"""The port's define-by-run tape (deepflows_tpu_torch/tensor.py) against the
JAX package's on the CPU, op by op: every op and factory of ``tensor.py``'s
``__all__`` at small shapes, the same seeded numpy inputs through the JAX
tape on ``Device('cpu')`` and the port's on the CPU, values and gradients
within 1e-6 (f32).  Then the JAX package's own tape tests
(tests/test_autograd.py and tests/test_tensor_misc.py) run on the port: the
finite-difference table, the grad contexts, ``retain_graph``, the leaves
``free_graph`` keeps, ``dispose``, accumulation, in-place refusal, ties,
array-index slices, ``concat``, deepcopy and ``np.asarray``.

The JAX package's scalar-constant cache (``test_scalar_const_cache_*``)
has no counterpart here: its tests are not ported.
"""

import copy

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu_torch import Graph, Tensor, config, enable_grad, no_grad

TOL = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.default_rng(0)
X23 = RNG.standard_normal((2, 3)).astype(np.float32)
Y23 = RNG.standard_normal((2, 3)).astype(np.float32)
POS = (np.abs(X23) + 0.5).astype(np.float32)
ROW = RNG.standard_normal((1, 3)).astype(np.float32)
M34 = RNG.standard_normal((3, 4)).astype(np.float32)
B523 = RNG.standard_normal((5, 2, 3)).astype(np.float32)
V3 = RNG.standard_normal((3,)).astype(np.float32)
TIES = np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]], np.float32)
X234 = RNG.standard_normal((2, 3, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both tapes empty and recording around each test (an earlier file's
    ``Module.eval()`` may have left either flag off); ``use_pallas`` off;
    a Tensor made without ``device=`` on the CPU (the port's default is the
    card)."""
    from deepflows_tpu import config as jconfig

    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")

    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    saved = (jconfig.use_pallas, config.use_pallas)
    yield
    jconfig.use_pallas, config.use_pallas = saved
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)


class _Cube:
    """A user op written the JAX package's way, in either package."""

    @staticmethod
    def make(pkg):
        class Cube(pkg.UnaryOperator):
            def forward(self, x):
                return x.data * x.data * x.data

            def grad_fn(self, x, grad):
                return grad * x.data * x.data * 3.0

        class Hypot(pkg.BinaryOperator):
            def __init__(self, x, y, scale=1.0):
                self.scale = scale
                super().__init__(x, y)

            def forward(self, x, y):
                return (x * x + y * y).sqrt() * self.scale

            def grad_fn(self, node, grad):
                return grad * node.data * self.scale * self.scale / self.data

        return Cube, Hypot


# (name, build(pkg, *tensors), inputs): every op of tensor.py's __all__
OPS = [
    ("add", lambda p, x, y: p.add(x, y), (X23, ROW)),
    ("add_op_scalar", lambda p, x: 2.0 + x + 1.5, (X23,)),
    ("sub", lambda p, x, y: p.sub(x, y), (X23, Y23)),
    ("rsub", lambda p, x: 3.0 - x, (X23,)),
    ("mul", lambda p, x, y: x * y, (X23, ROW)),
    ("mul_self", lambda p, x: x * x, (X23,)),
    ("div", lambda p, x, y: p.div(x, y + 3.0), (X23, POS)),
    ("rdiv", lambda p, x: 1.0 / (x + 10.0), (X23,)),
    ("pow_scalar", lambda p, x: p.pow(x, 3.0), (POS,)),
    ("pow_tensor", lambda p, x, y: x ** y, (POS, Y23)),
    ("rpow", lambda p, x: 2.0 ** x, (X23,)),
    ("matmul", lambda p, a, b: p.matmul(a, b), (X23, M34)),
    ("matmul_vec_left", lambda p, v, b: v @ b, (V3, M34)),
    ("matmul_vec_right", lambda p, a, v: a @ v, (X23, V3)),
    ("matmul_batched", lambda p, a, b: a @ b, (B523, M34)),
    ("abs", lambda p, x: p.abs(x), (X23 + 0.3,)),
    ("sum_all", lambda p, x: p.sum(x), (X23,)),
    ("sum_axis", lambda p, x: x.sum(axis=1), (X234,)),
    ("sum_axes_keepdims", lambda p, x: p.sum(x, (0, 2), True), (X234,)),
    ("mean_all", lambda p, x: p.mean(x), (X23,)),
    ("mean_axis", lambda p, x: x.mean(axis=0), (X234,)),
    ("mean_axes_keepdims", lambda p, x: p.mean(x, (1, 2), True), (X234,)),
    ("max_all_ties", lambda p, x: p.max(x), (TIES,)),
    ("max_axis_ties", lambda p, x: x.max(axis=1), (TIES,)),
    ("max_keepdims", lambda p, x: p.max(x, 0, True), (X234,)),
    ("min_axis_ties", lambda p, x: x.min(axis=1), (TIES,)),
    ("min_all", lambda p, x: p.min(x), (X23,)),
    ("exp", lambda p, x: p.exp(x), (X23,)),
    ("log", lambda p, x: p.log(x), (POS,)),
    ("maximum_scalar_ties", lambda p, x: p.maximum(x, 2.0), (TIES,)),
    ("maximum_tensor", lambda p, x, y: p.maximum(x, y), (X23, Y23)),
    ("maximum_tensor_ties", lambda p, x, y: p.maximum(x, y), (TIES, TIES.copy())),
    ("minimum_scalar_ties", lambda p, x: p.minimum(x, 2.0), (TIES,)),
    ("minimum_tensor", lambda p, x, y: p.minimum(x, y), (X23, Y23)),
    ("sqrt", lambda p, x: p.sqrt(x), (POS,)),
    ("square", lambda p, x: p.square(x), (X23,)),
    ("Reshape", lambda p, x: p.Reshape(x, (3, 2)), (X23,)),
    ("reshape_method", lambda p, x: x.reshape(4, 6), (X234,)),
    ("transpose_none", lambda p, x: p.transpose(x), (X234,)),
    ("transpose_axes", lambda p, x: p.transpose(x, (1, 2, 0)), (X234,)),
    ("transpose_method", lambda p, x: x.transpose(2, 0, 1), (X234,)),
    ("T", lambda p, x: x.T, (X23,)),
    ("swapaxes", lambda p, x: x.swapaxes(0, 2), (X234,)),
    ("flatten", lambda p, x: x.flatten(1), (X234,)),
    ("concat_axis0", lambda p, x, y: p.concat([x, y], axis=0), (X23, ROW)),
    ("concat_axis1", lambda p, x, y: p.concat([x, y, x], axis=1), (X23, Y23)),
    ("get_slice_basic", lambda p, x: p.get_slice(x, (0, slice(1, None))), (X23,)),
    ("getitem_negative", lambda p, x: x[:, -1], (X234,)),
    ("getitem_array_repeats", lambda p, x: x[np.array([0, 1, 0, 0])], (X23,)),
    ("neg_pos", lambda p, x: -(+x), (X23,)),
    ("user_unary_op", lambda p, x: _Cube.make(p)[0](x), (X23,)),
    ("user_binary_op", lambda p, x, y: _Cube.make(p)[1](x, y, scale=2.0), (X23, Y23)),
]


def _run(pkg, build, arrays):
    ts = [pkg.Tensor(a.copy(), device="cpu", requires_grad=True) for a in arrays]
    out = build(pkg, *ts)
    w = np.random.default_rng(11).standard_normal(tuple(out.shape)).astype(np.float32)
    (out * pkg.Tensor(w, device="cpu")).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy()) for t in ts]


@pytest.mark.parametrize("name,build,arrays", OPS, ids=[o[0] for o in OPS])
def test_op_matches_jax_tape(name, build, arrays):
    want, want_grads = _run(df, build, arrays)
    got, grads = _run(dt, build, arrays)
    np.testing.assert_allclose(got, want, **TOL)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"gradient of operand {i}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_matmul_route_matches_jax_tape(use_pallas):
    """2-D f32 products with ``use_pallas`` on take ops.matmul (its plain
    twin here) forward and backward; the JAX tape its Pallas kernel in
    interpret mode on the JAX device."""
    from deepflows_tpu import config as jconfig

    jconfig.use_pallas = config.use_pallas = use_pallas
    a, b = RNG.standard_normal((8, 5)).astype(np.float32), M34[:, :2].copy()
    b = RNG.standard_normal((5, 6)).astype(np.float32)
    res = {}
    for pkg, dev in ((df, "tpu"), (dt, "cpu")):
        ta = pkg.Tensor(a, device=dev, requires_grad=True)
        tb = pkg.Tensor(b, device=dev, requires_grad=True)
        out = ta @ tb
        (out * out).sum().backward()
        res[pkg.__name__] = (out.numpy(), ta.grad.numpy(), tb.grad.numpy())
    for got, want in zip(res["deepflows_tpu_torch"], res["deepflows_tpu"]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne", "argmax"])
def test_comparisons_and_argmax_match_jax(op):
    for pkg in (df, dt):
        t = pkg.Tensor(TIES, device="cpu", requires_grad=True)
        out = {"lt": lambda: t < 2.0, "le": lambda: t <= 2.0, "gt": lambda: t > 2.0,
               "ge": lambda: t >= 2.0, "eq": lambda: t.eq(2.0), "ne": lambda: t.ne(2.0),
               "argmax": lambda: t.argmax(1)}[op]()
        assert not out.requires_grad
        if pkg is df:
            want = np.asarray(out.numpy())
        else:
            got = out.numpy()
    np.testing.assert_array_equal(got, want)
    if op != "argmax":
        assert got.dtype == np.float32


@pytest.mark.parametrize("factory", ["zeros", "ones", "empty", "zeros_like", "ones_like",
                                     "arange", "randn", "rand", "uniform"])
def test_factories(factory):
    t = {"zeros": lambda: dt.zeros((2, 3), device="cpu"),
         "ones": lambda: dt.ones((2, 3), device="cpu", requires_grad=True),
         "empty": lambda: dt.empty((2, 3), device="cpu"),
         "zeros_like": lambda: dt.zeros_like(dt.ones((2, 3), device="cpu")),
         "ones_like": lambda: dt.ones_like(dt.zeros((2, 3), device="cpu")),
         "arange": lambda: dt.arange(6, device="cpu").reshape(2, 3),
         "randn": lambda: dt.randn(2, 3, device="cpu", seed=0),
         "rand": lambda: dt.rand(2, 3, device="cpu", seed=0),
         "uniform": lambda: dt.uniform(-1, 1, (2, 3), device="cpu", seed=0)}[factory]()
    assert isinstance(t, Tensor) and tuple(t.shape) == (2, 3)
    assert t.requires_grad == (factory == "ones")
    want = {"zeros": 0.0, "ones": 6.0, "empty": 0.0, "zeros_like": 0.0, "ones_like": 6.0,
            "arange": 15.0}
    if factory in want:
        assert float(t.numpy().sum()) == want[factory]
    if factory in ("randn", "rand", "uniform"):  # a seed gives the same draw
        again = getattr(dt, factory)(*((2, 3) if factory != "uniform" else (-1, 1, (2, 3))),
                                     device="cpu", seed=0)
        np.testing.assert_array_equal(t.numpy(), again.numpy())
        if factory == "uniform":
            assert t.numpy().min() >= -1 and t.numpy().max() <= 1


# ---------------------------------------------------------------- the JAX tape tests
def numeric_grad(f, x, eps=1e-3):
    g = np.zeros_like(x, dtype=np.float64)
    flat, gf = x.reshape(-1), g.reshape(-1)
    for i in range(flat.size):
        old = flat[i]
        flat[i] = old + eps
        fp = f(x.astype(np.float32))
        flat[i] = old - eps
        fm = f(x.astype(np.float32))
        flat[i] = old
        gf[i] = (fp - fm) / (2 * eps)
    return g


FD = [
    ("add", lambda x: (x + 2.0).sum(), X23),
    ("sub", lambda x: (3.0 - x).sum(), X23),
    ("mul", lambda x: (x * x).sum(), X23),
    ("div", lambda x: (1.0 / (x + 10.0)).sum(), X23),
    ("pow", lambda x: (x**3.0).mean(), POS),
    ("exp", lambda x: dt.exp(x).sum(), X23),
    ("log", lambda x: dt.log(x).sum(), POS),
    ("abs", lambda x: dt.abs(x).sum(), X23 + 0.3),
    ("sqrt", lambda x: dt.sqrt(x).sum(), POS),
    ("mean_all", lambda x: x.mean(), X23),
    ("mean_axis", lambda x: x.mean(axis=0).sum(), X23),
    ("sum_keepdims", lambda x: x.sum(axis=1, keepdims=True).sum(), X23),
    ("max_all", lambda x: x.max(), X23),
    ("max_axis", lambda x: x.max(axis=1).sum(), X23),
    ("min_axis", lambda x: x.min(axis=0).sum(), X23),
    ("maximum", lambda x: dt.maximum(x, 0.1).sum(), X23),
    ("reshape", lambda x: x.reshape(3, 2).sum(axis=0).max(), X23),
    ("transpose", lambda x: (x.T * x.T).sum(), X23),
    ("slice", lambda x: x[0, 1:].sum(), X23),
]


@pytest.mark.parametrize("name,build,x", FD, ids=[f[0] for f in FD])
def test_op_grads_finite_differences(name, build, x):
    t = Tensor(x.copy(), requires_grad=True)
    build(t).backward()

    def f(a):
        return float(build(Tensor(a)).numpy())

    np.testing.assert_allclose(t.grad.numpy(), numeric_grad(f, x.astype(np.float64)),
                               rtol=2e-2, atol=1e-3)


def test_no_grad_blocks_tape():
    with no_grad():
        x = Tensor(X23, requires_grad=True)
        y = x * 2.0
    assert not x.requires_grad and not y.requires_grad
    assert len(Graph.node_list) == 0


def test_no_grad_keeps_torch_graph_off_for_tape_ops():
    x = Tensor(X23, requires_grad=True)
    with no_grad():
        y = x * 2.0 + 1.0
    assert y.grad_fn is None and not y.requires_grad
    assert len(Graph.node_list) == 1


def test_no_grad_as_decorator():
    @no_grad()
    def fn():
        return Tensor(X23, requires_grad=True).requires_grad

    assert fn() is False
    assert dt.is_grad_enable() and dt.is_grad_enabled()

    @enable_grad()
    def on():
        return dt.is_grad_enable()

    dt.set_grad_enabled(False)
    assert on() is True and dt.is_grad_enable() is False


def test_second_backward_with_retain_graph():
    x = Tensor(X23, requires_grad=True)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    g1 = x.grad.numpy().copy()
    x.zero_grad()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), g1)
    y.backward()  # freed: no longer on the tape, returns quietly
    np.testing.assert_allclose(x.grad.numpy(), g1)


def test_backward_refuses_non_scalar_and_ignores_off_tape():
    x = Tensor(X23, requires_grad=True)
    with pytest.raises(ValueError):
        (x * 2.0).backward()
    Tensor(X23).sum().backward()  # not on the tape: nothing happens


def test_free_graph_keeps_leaves():
    x = Tensor(X23, requires_grad=True)
    (x * 3.0).sum().backward()
    assert any(n is x for n in Graph.node_list)
    assert all(n.is_leaf for n in Graph.node_list)
    Graph.free_graph_all()
    assert len(Graph.node_list) == 0


def test_dispose():
    x = Tensor(X23, requires_grad=True)
    y = x * 2.0
    assert any(n is y for n in Graph.node_list)
    y.dispose()
    assert all(n is not y for n in Graph.node_list)


def test_grad_accumulation():
    x = Tensor(X23, requires_grad=True)
    (x.sum() * 1.0).backward(retain_graph=True)
    (x.sum() * 1.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full((2, 3), 2.0))


def test_inplace_forbidden_on_grad_nodes():
    x = Tensor(X23, requires_grad=True)
    with pytest.raises(AssertionError):
        x += 1.0
    with pytest.raises(AssertionError):
        x[0, 0] = 5.0
    with pytest.raises(AssertionError):
        x @= Tensor(np.eye(3, dtype=np.float32))


def test_inplace_on_constants_and_data():
    t = Tensor(X23.copy())
    t += 1.0
    t *= 2.0
    t -= 1.0
    t /= 3.0
    t[0, 0] = 7.0
    want = ((X23 + 1) * 2 - 1) / 3
    want[0, 0] = 7.0
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6)
    t @= Tensor(np.ones((3, 2), np.float32))
    assert tuple(t.shape) == (2, 2)
    w = Tensor(X23.copy(), requires_grad=True)  # a leaf is updated through .data
    (w * w).sum().backward()
    with no_grad():
        w.data -= 0.5 * w.grad
    np.testing.assert_allclose(w.numpy(), X23 - 0.5 * 2 * X23, rtol=1e-6)


def test_detach_and_comparisons():
    x = Tensor(X23, requires_grad=True)
    d = x.detach()
    assert not d.requires_grad and isinstance(d, Tensor)
    c = x > 0
    assert not c.requires_grad
    np.testing.assert_allclose(c.numpy(), (X23 > 0).astype(np.float32))
    (x * 2.0).sum().backward()
    assert x.grad is not None and d.grad is None


def test_ties_split_evenly():
    x = Tensor(TIES, requires_grad=True)
    x.max(axis=1).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[0, 0.5, 0.5], [0.5, 0.5, 0]])
    y = Tensor(TIES, requires_grad=True)
    dt.maximum(y, 2.0).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), [[0, 1, 1], [0.5, 0.5, 0]])


def test_slice_gradient_with_array_index():
    x = Tensor(np.arange(12, dtype=np.float32).reshape(3, 4), requires_grad=True)
    idx = np.array([0, 2, 0])
    out = x[idx]
    assert tuple(out.shape) == (3, 4)
    out.sum().backward()
    want = np.zeros((3, 4), np.float32)
    np.add.at(want, idx, 1.0)
    np.testing.assert_allclose(x.grad.numpy(), want)


def test_concat_grad():
    a = Tensor(X23, requires_grad=True)
    b = Tensor(X23 * 2, requires_grad=True)
    y = dt.concat([a, b], axis=1)
    assert tuple(y.shape) == (2, 6)
    (y * y).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), 2 * X23, rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), 4 * X23, rtol=1e-5)


def test_deepcopy_is_a_fresh_leaf():
    x = Tensor(X23, requires_grad=True, name="w")
    y = (x * 2.0)
    c = copy.deepcopy(x)
    assert c is not x and c.requires_grad and c.grad_fn is None and c.name == "w"
    assert any(n is c for n in Graph.node_list)
    np.testing.assert_array_equal(c.numpy(), X23)
    c2 = copy.deepcopy(y)  # a non-leaf copies as a leaf of its values
    assert c2.grad_fn is None
    c.data[0, 0] = 99.0
    assert x.numpy()[0, 0] == X23[0, 0]


def test_np_asarray_uses_array_protocol():
    t = Tensor(RNG.standard_normal((64, 64)).astype(np.float32))
    n0 = len(Graph.node_list)
    a = np.asarray(t)
    assert a.shape == (64, 64) and len(Graph.node_list) == n0
    np.testing.assert_array_equal(a, t.numpy())
    with pytest.raises(ValueError):
        np.asarray(t, copy=False)


def test_reflected_operators_and_misc():
    A = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    t = Tensor(A)
    np.testing.assert_allclose((10.0 - t).numpy(), 10.0 - A)
    np.testing.assert_allclose((10.0 / t).numpy(), 10.0 / A, rtol=1e-6)
    np.testing.assert_allclose((2.0**t).numpy(), 2.0**A, rtol=1e-5)
    np.testing.assert_allclose((-t).numpy(), -A)
    np.testing.assert_allclose(abs(Tensor(-A)).numpy(), A)
    assert len(t) == 2 and "Tensor" in repr(t) and str(t)
    assert t.argmax(1).numpy().tolist() == [1, 1]
    np.testing.assert_allclose(t.swapaxes(0, 1).numpy(), A.T)


def test_constructor_rules():
    """The JAX constructor: float64 becomes f32, int64 int32; a Tensor
    argument's storage is shared; a scalar operand keeps bf16."""
    assert Tensor(np.ones(2)).dtype == torch.float32
    assert Tensor(np.arange(3)).dtype == torch.int32
    assert Tensor(2.5).dtype == torch.float32 and Tensor(2.5).dim() == 0
    a = Tensor(X23.copy())
    b = Tensor(a)
    b[0, 0] = 42.0
    assert a.numpy()[0, 0] == 42.0
    h = Tensor(X23, dtype="bfloat16")
    assert (h * 2.0).dtype == torch.bfloat16 and (1.0 - h).dtype == torch.bfloat16
    assert dt.maximum(h, 0.0).dtype == torch.bfloat16
    assert Tensor(X23, requires_grad=True).to("cpu").requires_grad
    with no_grad():
        assert not Tensor(X23, requires_grad=True).requires_grad


def test_mixed_devices_refused():
    """A tape op of two operands on different devices raises (the JAX tape
    asserts); checked here with the meta device, which needs no card."""
    from deepflows_tpu_torch.tensor import _same_device

    x = Tensor(X23)
    with pytest.raises(AssertionError):
        _same_device(x, torch.empty(2, 3, device="meta"))
    with pytest.raises(AssertionError):
        x + torch.empty(2, 3, device="meta")
