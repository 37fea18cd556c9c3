"""The port's Adam (deepflows_tpu_torch/optim/adam.py) and its fused kernel's
plain twin (deepflows_tpu_torch/ops/adam.py) against the JAX package's
Pallas ``fused_adam`` (interpret mode on the CPU) and ``optim.Adam``.

Parameters, gradients and moments are numpy arrays from a seed, handed to
both packages.  Tolerances are tests/test_pallas.py's: the fused update
rtol 1e-5 / atol 1e-6 against the JAX kernel, and Adam(fused=True) against
fused=False rtol 1e-4 / atol 1e-5 (the two evaluate the step in different
orders, as in JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.ops import pallas_kernels as pk
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.utils import load_jax_optimizer_state

RNG = np.random.default_rng(41)


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _hyper(lr, b1, b2, eps, wd, t):
    return np.asarray([lr, b1, b2, eps, wd, 1 - b1**t, 1 - b2**t], np.float32)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("n", [1000, 4096, 5000])
def test_fused_adam_matches_jax_kernel(n, wd):
    p, g = RNG.standard_normal(n).astype(np.float32), RNG.standard_normal(n).astype(np.float32)
    v = RNG.standard_normal(n).astype(np.float32) * 0.1
    s = np.abs(RNG.standard_normal(n).astype(np.float32)) * 0.01
    hyper = _hyper(0.01, 0.9, 0.999, 1e-8, wd, 3)
    want = pk.fused_adam(*(jnp.asarray(a) for a in (p, g, v, s, hyper)))
    tp, tg, tv, ts = (torch.from_numpy(a.copy()) for a in (p, g, v, s))
    out = ops.fused_adam(tp, tg, tv, ts, torch.from_numpy(hyper))
    assert out[0][0] is tp and out[1][0] is tv and out[2][0] is ts  # in place
    for got, ref in zip((tp, tv, ts), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_adam_updates_a_list_in_one_call():
    """Tensors of several shapes in one call equal one JAX kernel call each."""
    shapes = [(37, 5), (1,), (4096,), (3, 3, 7)]
    hyper = _hyper(5e-3, 0.9, 0.999, 1e-8, 5e-4, 7)
    ps, gs, vs, ss, wants = [], [], [], [], []
    for shape in shapes:
        p, g = (RNG.standard_normal(shape).astype(np.float32) for _ in range(2))
        v = RNG.standard_normal(shape).astype(np.float32) * 0.1
        s = np.abs(RNG.standard_normal(shape).astype(np.float32)) * 0.01
        wants.append(pk.fused_adam(*(jnp.asarray(a) for a in (p, g, v, s, hyper))))
        for lst, a in zip((ps, gs, vs, ss), (p, g, v, s)):
            lst.append(torch.from_numpy(a.copy()))
    ops.fused_adam(ps, gs, vs, ss, torch.from_numpy(hyper))
    for i, want in enumerate(wants):
        for got, ref in zip((ps[i], vs[i], ss[i]), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_adam_checks_its_operands():
    p = torch.zeros(8)
    h = torch.zeros(7)
    with pytest.raises(TypeError):
        ops.fused_adam(p.to(torch.bfloat16), p, p.clone(), p.clone(), h)
    with pytest.raises(ValueError):
        ops.fused_adam(p, torch.zeros(9), p.clone(), p.clone(), h)
    with pytest.raises(ValueError):
        ops.fused_adam([p], [p, p], [p], [p], h)
    with pytest.raises(ValueError):
        ops.fused_adam(p, p, p.clone(), p.clone(), torch.zeros(6))


def _grads(shape, steps):
    return [RNG.standard_normal(shape).astype(np.float32) for _ in range(steps)]


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_jax_adam(wd):
    """Four eager steps of the port's Adam, fused and not, against the JAX
    package's Adam on the same gradients."""
    w0 = RNG.standard_normal((37, 5)).astype(np.float32)
    gs = _grads((37, 5), 4)
    jp = jnn.Parameter(Tensor(w0.copy(), device="tpu"))
    jopt = joptim.Adam([jp], lr=0.01, weight_decay=wd)
    for g in gs:
        jp.grad = df.BackendTensor(g, device=jp.device)
        jopt.step()
    for fused in (False, True):
        tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        topt = optim.Adam([tp], lr=0.01, weight_decay=wd, fused=fused)
        for g in gs:
            tp.grad = torch.from_numpy(g)
            topt.step()
        tol = dict(rtol=1e-4, atol=1e-5) if fused else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), **tol)
        assert topt.t == jopt.t == 5
        np.testing.assert_allclose(topt.v[0].numpy(), np.asarray(jopt.v[0]), **tol)
        np.testing.assert_allclose(topt.s[0].numpy(), np.asarray(jopt.s[0]), **tol)


def test_adam_skips_parameters_without_grads_and_keeps_f32_state():
    a = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    b = torch.nn.Parameter(torch.ones(4))
    opt = optim.Adam([a, b], lr=0.1)
    assert [s.dtype for s in opt.s] == [torch.float32, torch.float32]
    b.grad = torch.ones(4)
    opt.step()
    assert torch.equal(a.detach(), torch.ones(3, dtype=torch.bfloat16))
    assert (b.detach() < 1).all() and a.dtype == torch.bfloat16
    a.grad = torch.ones(3, dtype=torch.bfloat16)
    opt.step()
    assert a.dtype == torch.bfloat16 and (a.detach() < 1).all()
    opt.zero_grad()
    assert a.grad is None and b.grad is None
    with pytest.raises(TypeError, match="f32"):
        fused = optim.Adam([a], fused=True)
        a.grad = torch.ones(3, dtype=torch.bfloat16)
        fused.step()
    sr = optim.Adam([a], lr=0.1, stochastic_round=True, fused=True)
    before = a.detach().clone()
    a.grad = torch.ones(3, dtype=torch.bfloat16)
    sr.step()
    assert a.dtype == torch.bfloat16 and (a.detach() < before).all()
    assert sr.s[0].dtype == torch.float32


def test_state_dict_round_trip_and_jax_state_import():
    w0 = RNG.standard_normal((6, 3)).astype(np.float32)
    gs = _grads((6, 3), 3)
    jp = jnn.Parameter(Tensor(w0.copy(), device="tpu"))
    jopt = joptim.Adam([jp], lr=0.01)
    for g in gs:
        jp.grad = df.BackendTensor(g, device=jp.device)
        jopt.step()
    jstate = jopt.state_dict()["state"]
    tp = torch.nn.Parameter(torch.from_numpy(jp.numpy().copy()))
    topt = optim.Adam([tp], lr=0.01)
    load_jax_optimizer_state(topt, {k: (np.asarray(x) if k == "t" else [np.asarray(a) for a in x])
                                    for k, x in jstate.items()})
    assert topt.t == jopt.t == 4
    np.testing.assert_array_equal(topt.v[0].numpy(), np.asarray(jstate["v"][0]))
    sd = topt.state_dict()
    other = optim.Adam([tp], lr=1.0)
    other.load_state_dict(sd)
    assert other.lr == 0.01 and other.t == 4
    with pytest.raises(ValueError, match="shape"):
        load_jax_optimizer_state(topt, {"v": [np.zeros(3)], "s": [np.zeros(3)], "t": 1})
    with pytest.raises(ValueError, match="slots"):
        load_jax_optimizer_state(topt, {"v": [], "s": [], "t": 1})
