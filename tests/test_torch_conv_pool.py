"""The port's convolution and pooling (deepflows_tpu_torch ``nn.functional``
``conv2d``, ``conv1d``, ``max_pool1d/2d``, ``avg_pool1d/2d``,
``adaptive_avg_pool2d``, ``flatten`` and the activations of the CNN slice,
and the modules ``Conv1d``, ``Conv2d``, ``WSConv2d``, the pools and
``Flatten``) against the JAX package's on the CPU: outputs and input and
weight gradients, from numpy inputs made from a seed.

Tolerances: f32 rtol 1e-5 with an atol of 1e-5 of the largest reference
value (the two frameworks sum a window in other orders); bf16 rtol and
atol 0.05 (tests/test_flash_attention.py's bf16 bound) scaled by that
largest value.  The JAX package's pooling edges are held: max pooling pads
with -inf, average pooling divides by the whole window, its padding
included, a stride of 0 means the window, and adaptive pooling of a size
the output does not divide uses floor/ceil bins (7 → 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu.nn import functional as JF
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.nn import functional as TF
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(131)
TOL = {"f32": 1e-5, "bf16": 0.05}


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _rand(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype] * scale)


def _both(jfn, tfn, arrays, dtype="f32"):
    """``jfn`` on JAX tensors and ``tfn`` on torch tensors of the same
    arrays; the loss is Σ out · g for a random g.  Returns both outputs and
    both lists of gradients."""
    if dtype == "bf16":
        arrays = [a.astype(jnp.bfloat16) for a in arrays]
    js = [Tensor(a, device="tpu", requires_grad=True) for a in arrays]
    jout = jfn(*js)
    g = _rand(jout.shape)
    if dtype == "bf16":
        g = g.astype(jnp.bfloat16)
    (jout * Tensor(g, device="tpu")).sum().backward()
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ts = [torch.from_numpy(np.asarray(a, np.float32)).to(tdt).requires_grad_() for a in arrays]
    tout = tfn(*ts)
    assert tout.dtype == tdt
    (tout * torch.from_numpy(np.asarray(g, np.float32)).to(tdt)).sum().backward()
    return (jout.numpy(), tout), [(j.grad.numpy(), t.grad) for j, t in zip(js, ts)]


def _check(jfn, tfn, arrays, dtype="f32"):
    (jo, to), grads = _both(jfn, tfn, arrays, dtype)
    _close(to, jo, dtype)
    for jg, tg in grads:
        _close(tg, jg, dtype)


CONV_CASES = [  # (Cin, Cout, groups, k, stride, padding, H)
    (4, 6, 1, 3, 1, 1, 9),
    (4, 6, 2, 3, 2, 0, 9),
    (6, 6, 6, 3, 1, 1, 8),   # depthwise
    (6, 6, 6, 3, 2, 2, 8),   # depthwise, stride 2
    (3, 8, 1, 5, 1, 3, 7),
    (4, 4, 1, 1, 2, 0, 8),
    (8, 4, 2, 7, 2, 3, 11),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_conv2d_matches_jax(case, dtype):
    cin, cout, groups, k, s, p, H = case
    x, w = _rand((2, cin, H, H + 1)), _rand((cout, cin // groups, k, k)) * 0.3
    _check(lambda a, b: JF.conv2d(a, b, p, s, groups),
           lambda a, b: TF.conv2d(a, b, p, s, groups), [x, w], dtype)


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_conv1d_matches_jax(case):
    cin, cout, groups, k, s, p, H = case
    x, w = _rand((2, cin, 3 * H)), _rand((cout, cin // groups, k)) * 0.3
    _check(lambda a, b: JF.conv1d(a, b, p, s, groups),
           lambda a, b: TF.conv1d(a, b, p, s, groups), [x, w])


POOL_CASES = [  # (k, stride, padding): stride 0 means the window
    (2, 0, 0), (2, 2, 0), (3, 2, 1), (3, 1, 1), (3, 2, 0), (2, 1, 1), (3, 3, 2), (4, 2, 3),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pool2d_matches_jax(case, kind, dtype):
    k, s, p = case
    x = _rand((2, 3, 9, 10))
    _check(lambda a: getattr(JF, f"{kind}_pool2d")(a, k, s, p),
           lambda a: getattr(TF, f"{kind}_pool2d")(a, k, s, p), [x], dtype)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pool1d_matches_jax(case, kind):
    k, s, p = case
    x = _rand((2, 3, 13))
    _check(lambda a: getattr(JF, f"{kind}_pool1d")(a, k, s, p),
           lambda a: getattr(TF, f"{kind}_pool1d")(a, k, s, p), [x])


def test_pooling_edges():
    """-inf padding for max (an all-negative input never sees a 0), the whole
    window for avg (a corner of ones averages to 4/9), stride 0."""
    x = -np.ones((1, 1, 4, 4), np.float32) - _rand((1, 1, 4, 4)) ** 2
    out = TF.max_pool2d(torch.from_numpy(x), 3, 2, 1)
    assert (out < 0).all()
    ones = torch.ones(1, 1, 4, 4)
    assert TF.avg_pool2d(ones, 3, 2, 1)[0, 0, 0, 0].item() == pytest.approx(4 / 9)
    assert TF.max_pool2d(ones, 2).shape == (1, 1, 2, 2)
    assert TF.avg_pool1d(torch.ones(1, 1, 9), 3).shape == (1, 1, 3)


@pytest.mark.parametrize("size,out", [(7, 3), (8, 4), (6, 1), (5, 5), (9, 2)])
def test_adaptive_avg_pool2d_matches_jax(size, out):
    x = _rand((2, 3, size, size))
    _check(lambda a: JF.adaptive_avg_pool2d(a, out),
           lambda a: TF.adaptive_avg_pool2d(a, out), [x])


@pytest.mark.parametrize("name,args", [("relu6", ()), ("leaky_relu", (0.1,)), ("sigmoid", ()),
                                       ("softmax", (1,)), ("log_softmax", (1,))])
def test_activations_match_jax(name, args):
    x = _rand((4, 5, 3)) * 4
    x[0, 0, 0] = 6.5  # above relu6's cap
    _check(lambda a: getattr(JF, name)(a, *args), lambda a: getattr(TF, name)(a, *args), [x])


@pytest.mark.parametrize("name,kw", [("ReLU6", {}), ("LeakyReLU", {"negative_slope": 0.2}),
                                     ("Sigmoid", {}), ("Softmax", {}), ("LogSoftmax", {"dim": 2})])
def test_activation_modules_match_jax(name, kw):
    x = _rand((3, 4, 5)) * 3
    _check(getattr(jnn, name)(**kw), getattr(tnn, name)(**kw), [x])


def test_flatten_matches_jax():
    x = _rand((2, 3, 4, 5))
    for start in (1, 2):
        _check(jnn.Flatten(start), tnn.Flatten(start), [x])
        _check(lambda a: JF.flatten(a, start), lambda a: TF.flatten(a, start), [x])


MODULE_CASES = {  # module name, constructor arguments, input shape
    "conv2d": ("Conv2d", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9, 9)),
    "conv2d_groups_nobias": ("Conv2d", (4, 6, 3), dict(padding=1, groups=2, bias=False),
                             (2, 4, 8, 8)),
    "conv1d": ("Conv1d", (4, 6, 5), dict(stride=2, padding=2), (2, 4, 17)),
    "wsconv2d": ("WSConv2d", (4, 6, 3), dict(padding=1, gamma=1.7), (2, 4, 8, 8)),
    "wsconv2d_depthwise": ("WSConv2d", (6, 6, 3), dict(padding=1, groups=6, bias=False),
                           (2, 6, 8, 8)),
    "maxpool2d": ("MaxPool2d", (3,), dict(stride=2, padding=1), (2, 3, 9, 9)),
    "avgpool2d": ("AvgPool2d", (2,), {}, (2, 3, 8, 8)),
    "maxpool1d": ("MaxPool1d", (3,), dict(stride=1, padding=1), (2, 3, 9)),
    "avgpool1d": ("AvgPool1d", (3,), dict(stride=2), (2, 3, 9)),
    "adaptive": ("AdaptiveAvgPool2d", (3,), {}, (2, 3, 7, 7)),
}


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_modules_match_jax(case):
    """State dict keys, shapes and values crossing with load_jax_state_dict
    (a conv bias is (1, out, 1[, 1]), WSConv2d's gain (out, 1, 1, 1)), the
    output and every gradient."""
    name, args, kw, shape = MODULE_CASES[case]
    df.manual_seed(3)
    jm = getattr(jnn, name)(*args, device="tpu", **kw) if name.startswith(("Conv", "WS")) \
        else getattr(jnn, name)(*args, **kw)
    tm = getattr(tnn, name)(*args, device="cpu", **kw) if name.startswith(("Conv", "WS")) \
        else getattr(tnn, name)(*args, **kw)
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert {k: v.shape for k, v in jsd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    load_jax_state_dict(tm, jsd)
    x = _rand(shape)
    _check(jm, tm, [x])
    tparams = dict(tm.named_parameters())
    for pname, p in jm.named_parameters():
        _close(tparams[pname].grad, p.grad.numpy(), "f32")
