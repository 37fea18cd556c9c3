"""The port's BatchNorm1d and BatchNorm2d against the JAX package's on the
CPU, at n = B·H·W = 8, where the unbiased variance is n/(n-1) = 1.14 times
the biased one: torch's own batch norm would move ``running_var`` towards
the unbiased variance, the JAX package (and so the port) towards the
biased one.

Over 3 training steps: outputs, the gradients of input, weight and bias,
and both running statistics; then eval, on the running statistics.  The
state dict is the JAX package's: weight, bias, running_mean and
running_var of shape (1, C[, 1[, 1]]) and no num_batches_tracked.  A bf16
input keeps the buffers f32 and the output bf16.

Tolerances: f32 rtol 1e-5 and atol 1e-5 (outputs of order 1); bf16 rtol
and atol 0.05 (tests/test_flash_attention.py's bf16 bound: the JAX package
computes the batch statistics in bf16, the port in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(7)
TOL = {"f32": 1e-5, "bf16": 0.05}
SHAPES = {"2d": (2, 3, 2, 2), "1d": (2, 3, 4), "1d_flat": (8, 3)}  # n = 8 a channel


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _pair(kind, affine=True):
    cls = "BatchNorm2d" if kind == "2d" else "BatchNorm1d"
    jm = getattr(jnn, cls)(3, affine=affine, device="tpu")
    tm = getattr(tnn, cls)(3, affine=affine, device="cpu")
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    if affine:  # weights away from the init, so that the affine shows
        jsd["weight"] = (1 + RNG.standard_normal(jsd["weight"].shape) * 0.3).astype(np.float32)
        jsd["bias"] = RNG.standard_normal(jsd["bias"].shape).astype(np.float32)
        jm.load_state_dict(jsd)
    load_jax_state_dict(tm, jsd)
    return jm, tm


def _close(got, want, dtype="f32"):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batchnorm_train_three_steps_then_eval(kind, affine):
    jm, tm = _pair(kind, affine)
    for step in range(3):
        x = (RNG.standard_normal(SHAPES[kind]) * 2 + step).astype(np.float32)
        g = RNG.standard_normal(SHAPES[kind]).astype(np.float32)
        xj = Tensor(x, device="tpu", requires_grad=True)
        out = jm(xj)
        (out * Tensor(g, device="tpu")).sum().backward()
        xt = torch.from_numpy(x).requires_grad_()
        tout = tm(xt)
        (tout * torch.from_numpy(g)).sum().backward()
        _close(tout, out.numpy())
        _close(xt.grad, xj.grad.numpy())
        if affine:
            _close(tm.weight.grad, jm.weight.grad.numpy())
            _close(tm.bias.grad, jm.bias.grad.numpy())
            for p in (*jm.parameters(), *tm.parameters()):
                p.grad = None
        Graph.free_graph_all()
        for name in ("running_mean", "running_var"):
            _close(getattr(tm, name), getattr(jm, name).numpy())
    jm.eval()
    tm.eval()
    x = RNG.standard_normal(SHAPES[kind]).astype(np.float32)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm(Tensor(x, device="tpu")).numpy())


def test_running_var_is_biased():
    """At n = 8 the EMA takes the biased variance: 0.9 + 0.1 · var_biased,
    not torch's 0.9 + 0.1 · var · 8/7."""
    tm = tnn.BatchNorm2d(3, device="cpu")
    x = torch.from_numpy(RNG.standard_normal(SHAPES["2d"]).astype(np.float32))
    tm(x)
    biased = x.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose(tm.running_var.reshape(-1).numpy(), (0.9 + 0.1 * biased).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.running_mean.reshape(-1).numpy(),
                               (0.1 * x.mean((0, 2, 3))).numpy(), rtol=1e-6, atol=1e-7)
    ref = torch.nn.BatchNorm2d(3)
    ref(x)
    assert not np.allclose(ref.running_var.numpy(), tm.running_var.reshape(-1).numpy(),
                           rtol=1e-3)


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_batchnorm_state_dict_is_jax_layout(kind):
    jm, tm = _pair(kind)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd) == ["weight", "bias", "running_mean", "running_var"]
    for k in jsd:
        assert tuple(tsd[k].shape) == tuple(np.asarray(jsd[k]).shape)
    assert tuple(tsd["weight"].shape) == ((1, 3, 1, 1) if kind == "2d" else (1, 3, 1))


def test_batchnorm_bf16_compute_keeps_f32_buffers():
    """One bf16 train step of a BN2d through both packages' whole steps: the
    loss agrees within the bf16 bound, the buffers stay f32 and agree."""
    x = RNG.standard_normal((4, 3, 2, 2)).astype(np.float32)
    y = RNG.integers(0, 3, 4).astype(np.int32)
    jm, tm = _pair("2d")
    jseq = jnn.Sequential(jm, jnn.Flatten(), jnn.Linear(12, 3, device="tpu"))
    tseq = tnn.Sequential(tm, tnn.Flatten(), tnn.Linear(12, 3, device="cpu"))
    load_jax_state_dict(tseq, {k: np.asarray(v) for k, v in jseq.state_dict().items()})
    from deepflows_tpu import optim as joptim

    jstep = JaxStep(jseq, joptim.SGD(jseq.parameters(), lr=0.1), jnn.CrossEntropyLoss(),
                    compute_dtype=jnp.bfloat16)
    tstep = CompiledTrainStep(tseq, optim.SGD(tseq.parameters(), lr=0.1),
                              tnn.CrossEntropyLoss(), compute_dtype=torch.bfloat16)
    for _ in range(2):
        lj, lt = float(jstep(x, y)), tstep(x, y)
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(float(lt), lj, rtol=TOL["bf16"])
    for name in ("running_mean", "running_var"):
        buf = getattr(tm, name)
        assert buf.dtype == torch.float32
        _close(buf, getattr(jm, name).numpy(), "bf16")
    assert tm.weight.dtype == torch.float32
    # eval on bf16 weights: output bf16, buffers still f32
    tseq.bfloat16()
    out = CompiledEvalStep(tseq)(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16 and tm.running_var.dtype == torch.float32
    assert CompiledEvalStep(tm)(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16
