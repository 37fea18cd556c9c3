"""``nn.torch_function`` (``deepflows_tpu_torch/nn/torch_bridge.py``) held
against the JAX package's ``nn.jax_function`` on the same math, written in
jnp there and in torch here: forward and every gradient within 1e-6 in
f32, with and without ``checkpoint``; one tape node, and one recorded node
under lazy mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu.nn import jax_function
from deepflows_tpu_torch import lazy
from deepflows_tpu_torch.nn import torch_function

TOL = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.default_rng(0)
X = RNG.standard_normal((4, 8)).astype(np.float32)
W = RNG.standard_normal((8, 3)).astype(np.float32) * 0.5
B = RNG.standard_normal((1, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    yield
    lazy.disable()
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)


def _jax_math(x, w, b):
    h = x @ w
    return jnp.tanh(h) * jax.nn.sigmoid(h) + b


def _torch_math(x, w, b):
    h = x @ w
    return torch.tanh(h) * torch.sigmoid(h) + b


def _run(pkg, fn, dev):
    x, w, b = (pkg.Tensor(a, device=dev, requires_grad=True) for a in (X, W, B))
    y = fn(x, w, b)
    loss = pkg.tensor.sum(y * y)
    loss.backward()
    return [np.asarray(y.numpy())] + [np.asarray(t.grad.numpy()) for t in (x, w, b)]


@pytest.mark.parametrize("checkpoint", [False, True])
def test_forward_and_gradients_match_jax_function(checkpoint):
    want = _run(df, jax_function(_jax_math, checkpoint=checkpoint), "tpu")
    got = _run(dt, torch_function(_torch_math, checkpoint=checkpoint), "cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    df.set_grad_enabled(True)


def test_decorator_and_repeated_operand():
    """``@torch_function``; ``f(t, t)`` sums both slots' cotangents, as the
    JAX bridge aliases a repeated operand."""

    @torch_function
    def prod(a, b):
        return a * b

    @jax_function
    def jprod(a, b):
        return a * b

    outs = []
    for pkg, fn, dev in ((df, jprod, "tpu"), (dt, prod, "cpu")):
        t = pkg.Tensor(X, device=dev, requires_grad=True)
        pkg.tensor.sum(fn(t, t)).backward()
        outs.append(np.asarray(t.grad.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], 2 * X, **TOL)


def test_one_tape_node():
    f = torch_function(_torch_math)
    x, w, b = (dt.Tensor(a, device="cpu", requires_grad=True) for a in (X, W, B))
    n = len(dt.Graph.node_list)
    y = f(x, w, b)
    assert len(dt.Graph.node_list) == n + 1 and dt.Graph.node_list[-1] is y
    assert isinstance(y, dt.Tensor) and y.requires_grad
    with dt.no_grad():  # no vjp kept, off the tape
        z = f(x, w, b)
    assert len(dt.Graph.node_list) == n + 1 and not z.requires_grad
    np.testing.assert_array_equal(z.numpy(), y.numpy())


def test_one_recorded_node_under_lazy_mode():
    f = torch_function(_torch_math, checkpoint=True)
    want = _run(dt, f, "cpu")
    lazy.enable()
    x, w, b = (dt.Tensor(a, device="cpu", requires_grad=True) for a in (X, W, B))
    n = lazy.lazy_stats()["nodes"]
    y = f(x, w, b)
    assert lazy.lazy_stats()["nodes"] == n + 1
    loss = dt.tensor.sum(y * y)
    loss.backward()
    got = [y.numpy(), x.grad.numpy(), w.grad.numpy(), b.grad.numpy()]
    lazy.disable()
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


def test_refuses_non_tensors():
    with pytest.raises(TypeError, match="must be tensors"):
        torch_function(_torch_math)(X, W, B)


def test_plain_tensors_and_autograd():
    """Outside the tape it is an autograd Function on plain tensors: its
    gradient is autograd's through the same math."""
    x, w, b = (torch.tensor(a, requires_grad=True) for a in (X, W, B))
    torch_function(_torch_math)(x, w, b).pow(2).sum().backward()
    got = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    _torch_math(x, w, b).pow(2).sum().backward()
    for g, t in zip(got, (x, w, b)):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=0)
