"""The port's ``nn.fuse_conv_bn`` and ``nn.GroupNorm`` against the JAX
package on the CPU, mirroring ``tests/test_fusion.py``.

Models are built in the JAX package, their BatchNorm statistics warmed by
three training forwards there, and the state copied to the port with
``load_jax_state_dict``; both packages fold, and the fused weights and the
fused eval outputs are compared.  The safety rules: a conv whose output
also feeds a residual add keeps its BN, as does a conv called twice, a BN
without running statistics and a WSConv2d; where the port is defined on
purpose, two convs that tie one weight keep their BNs (the JAX package
folds the shared weight twice), a model in train mode is folded in an eval
copy and itself left in train mode, and ``inplace=True`` refuses it (the
JAX package puts the caller's model in eval).  Tolerances: folded weights rtol
1e-5 / atol 1e-6 (both fold in float64); fused against unfused eval rtol
and atol 2e-4 for ResNet-18 and 1e-5 for a single pair (the JAX tests');
GroupNorm f32 rtol and atol 1e-5, bf16 0.05 (tests/test_torch_batchnorm.py's
bounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu.nn.fusion import fuse_conv_bn as jfuse
from deepflows_tpu_torch import models, nn, ops
from deepflows_tpu_torch.jit import CompiledEvalStep
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(37)
TOL = {"f32": 1e-5, "bf16": 0.05}


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it: later test files in the same process build their models from it."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = config.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    yield
    config.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)  # JAX's Module.eval() turns it off process-wide
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _bn_count(model):
    return sum(type(m).__name__ in ("BatchNorm1d", "BatchNorm2d") for m in model.modules())


def _warm_pair(jm, tm, x_shape):
    """Three JAX training forwards, so the running statistics move; then
    the state across to the port and both models in eval."""
    jm.train()
    for _ in range(3):
        jm(Tensor((RNG.normal(size=x_shape) * 2.0 + 0.5).astype(np.float32), device="cpu"))
    Graph.free_graph_all()
    jm.eval()
    df.set_grad_enabled(True)
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return tm.eval()


def _jout(jm, x):
    with df.no_grad():
        return jm(Tensor(x, device="cpu")).numpy()


def _tout(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def test_resnet18_folds_every_bn_as_jax():
    df.manual_seed(0)
    jm = jmodels.ResNet18(num_classes=10, small_input=True, device="cpu")
    tm = _warm_pair(jm, models.ResNet18(num_classes=10, small_input=True, device="cpu"),
                    (4, 3, 8, 8))
    x = RNG.normal(size=(2, 3, 8, 8)).astype(np.float32)
    want = _tout(tm, x)
    fused = nn.fuse_conv_bn(tm, torch.from_numpy(x))
    assert _bn_count(fused) == 0 and _bn_count(tm) == 20  # inplace=False: a copy
    convs = [m for m in fused.modules() if type(m) is nn.Conv2d]
    assert convs and all(c.bias is not None for c in convs)  # a bias grown on each
    np.testing.assert_allclose(_tout(fused, x), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(_tout(tm, x), want)  # the original untouched
    jfused = jfuse(jm, Tensor(x, device="cpu"))
    df.set_grad_enabled(True)
    tsd = fused.state_dict()
    jsd = jfused.state_dict()
    assert list(tsd) == list(jsd)
    for k, v in jsd.items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_tout(fused, x), _jout(jfused, x), rtol=2e-4, atol=2e-4)
    got = CompiledEvalStep(fused)(x)  # the fused model serves through the eval step
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _two_uses(mod, kind):
    """In the package ``mod``: a conv whose output feeds the BN and a
    residual add, or one conv called twice."""

    class Block(mod.Module):
        def __init__(self):
            super().__init__()
            self.conv = mod.Conv2d(3, 3, 3, padding=1, device="cpu")
            self.bn = mod.BatchNorm2d(3, device="cpu")

        def forward(self, x):
            if kind == "residual":
                h = self.conv(x)
                return self.bn(h) + h
            return self.bn(self.conv(self.conv(x)))

    return Block()


def _seq(mod, kind):
    if kind == "conv_bn_relu":
        return mod.Sequential(mod.Conv2d(3, 8, 3, padding=1, device="cpu"),
                              mod.BatchNorm2d(8, device="cpu"), mod.ReLU())
    if kind == "linear_bn1d":
        return mod.Sequential(mod.Linear(6, 16, device="cpu"), mod.BatchNorm1d(16, device="cpu"),
                              mod.ReLU(), mod.Linear(16, 4, device="cpu"))
    if kind == "conv1d_bn1d":
        return mod.Sequential(mod.Conv1d(3, 5, 3, padding=1, bias=False, device="cpu"),
                              mod.BatchNorm1d(5, device="cpu"))
    if kind == "wsconv":
        return mod.Sequential(mod.WSConv2d(3, 4, 3, padding=1, bias=False, device="cpu"),
                              mod.BatchNorm2d(4, device="cpu"))
    return _two_uses(mod, kind)


CASES = {  # kind: (input shape, BNs left after fusion, tolerance)
    "conv_bn_relu": ((4, 3, 8, 8), 0, 1e-5),
    "linear_bn1d": ((8, 6), 0, 1e-5),
    "conv1d_bn1d": ((4, 3, 7), 0, 1e-5),
    "wsconv": ((4, 3, 8, 8), 1, 1e-6),
    "residual": ((4, 3, 8, 8), 1, 1e-6),
    "called_twice": ((4, 3, 8, 8), 1, 1e-6),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_pairs_fold_or_stay_as_jax(kind):
    shape, left, tol = CASES[kind]
    df.manual_seed(1)
    jm = _seq(jnn, kind)
    tm = _warm_pair(jm, _seq(nn, kind), shape)
    x = RNG.normal(size=(2,) + shape[1:]).astype(np.float32)
    want = _tout(tm, x)
    fused = nn.fuse_conv_bn(tm, x)  # numpy in: placed on the model's device
    assert _bn_count(fused) == left
    np.testing.assert_allclose(_tout(fused, x), want, rtol=tol, atol=tol)
    jfused = jfuse(jm, Tensor(x, device="cpu"))
    df.set_grad_enabled(True)
    assert _bn_count(jfused) == left
    np.testing.assert_allclose(_tout(fused, x), _jout(jfused, x), rtol=tol, atol=tol)


def test_inplace_fuses_the_model_itself_and_leaves_modes():
    df.manual_seed(2)
    tm = _warm_pair(_seq(jnn, "conv_bn_relu"), _seq(nn, "conv_bn_relu"), (4, 3, 8, 8))
    x = torch.ones(2, 3, 8, 8)
    want = _tout(tm, x.numpy())
    live = nn.Linear(4, 3, device="cpu")
    pending = (live(torch.ones(2, 4)) ** 2).sum()  # a caller's graph, not yet backwarded
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            out = nn.fuse_conv_bn(tm, x, inplace=grad)
            assert torch.is_grad_enabled() is grad  # the caller's grad mode kept
    pending.backward()  # the caller's graph survives
    assert live.weight.grad is not None
    assert out is not tm and _bn_count(out) == 0  # the second call, on a copy
    assert _bn_count(tm) == 0 and not tm.training and not any(m.training for m in tm.modules())
    np.testing.assert_allclose(_tout(tm, x.numpy()), want, rtol=1e-5, atol=1e-5)


def test_bn_without_running_stats_is_kept():
    """A BN without running statistics cannot fold (the JAX rule)."""
    df.manual_seed(3)
    no_stats = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1, device="cpu"),
                             nn.BatchNorm2d(4, track_running_stats=False, device="cpu")).eval()
    assert _bn_count(nn.fuse_conv_bn(no_stats, torch.ones(2, 3, 8, 8))) == 1


def test_train_mode_model_folds_in_an_eval_copy_as_jax():
    """The usual call after training, on a model still in train mode: the
    copy is put in eval and every BN folds, as in the JAX package, while
    the caller's model keeps its train mode and its BN."""
    df.manual_seed(4)
    jm = _seq(jnn, "conv_bn_relu")
    tm = _warm_pair(jm, _seq(nn, "conv_bn_relu"), (4, 3, 8, 8))
    x = RNG.normal(size=(2, 3, 8, 8)).astype(np.float32)
    want = _tout(tm, x)  # the eval forward
    jm.train()
    tm.train()
    fused = nn.fuse_conv_bn(tm, x)
    assert _bn_count(fused) == 0 and not any(m.training for m in fused.modules())
    assert _bn_count(tm) == 1 and all(m.training for m in tm.modules())
    np.testing.assert_allclose(_tout(fused, x), want, rtol=1e-5, atol=1e-5)
    jfused = jfuse(jm, Tensor(x, device="cpu"))
    df.set_grad_enabled(True)
    assert _bn_count(jfused) == 0
    np.testing.assert_allclose(_tout(fused, x), _jout(jfused, x), rtol=1e-5, atol=1e-5)


def test_inplace_refuses_a_bn_in_train_mode():
    """In place, folding would freeze the statistics into the caller's own
    model: a BN in train mode is refused and the model left as it was."""
    df.manual_seed(5)
    tm = _seq(nn, "conv_bn_relu").train()
    with pytest.raises(ValueError, match="eval"):
        nn.fuse_conv_bn(tm, torch.ones(2, 3, 8, 8), inplace=True)
    assert _bn_count(tm) == 1 and all(m.training for m in tm.modules())


def test_convs_tying_one_weight_keep_their_bns():
    """Two convs that hold one weight Parameter, each feeding its own BN:
    folding would scale the shared weight twice, so neither folds."""

    class Tied(nn.Module):
        def __init__(self):
            super().__init__()
            self.a = nn.Conv2d(3, 3, 3, padding=1, device="cpu")
            self.b = nn.Conv2d(3, 3, 3, padding=1, device="cpu")
            self.b.weight = self.a.weight
            self.bn_a = nn.BatchNorm2d(3, device="cpu")
            self.bn_b = nn.BatchNorm2d(3, device="cpu")

        def forward(self, x):
            return self.bn_a(self.a(x)) + self.bn_b(self.b(x))

    dt.manual_seed(4)
    model = Tied()
    with torch.no_grad():
        for bn in (model.bn_a, model.bn_b):
            bn.running_mean.uniform_(-1, 1)
            bn.running_var.uniform_(0.5, 2)
    model.eval()
    x = torch.from_numpy(RNG.normal(size=(2, 3, 8, 8)).astype(np.float32))
    want = _tout(model, x.numpy())
    fused = nn.fuse_conv_bn(model, x)
    assert _bn_count(fused) == 2 and fused.a.weight is fused.b.weight
    np.testing.assert_allclose(_tout(fused, x.numpy()), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("affine", [True, False])
def test_group_norm_matches_jax(dtype, affine):
    df.manual_seed(5)
    jm = jnn.GroupNorm(4, 8, affine=affine, device="tpu")
    tm = nn.GroupNorm(4, 8, affine=affine, device="cpu")
    if affine:
        sd = {"weight": (1 + RNG.standard_normal(8) * 0.3).astype(np.float32),
              "bias": RNG.standard_normal(8).astype(np.float32)}
        jm.load_state_dict(sd)
        load_jax_state_dict(tm, sd)
        assert tuple(tm.weight.shape) == (8,) and not list(tm.buffers())
    x = (RNG.standard_normal((3, 8, 5, 4)) * 2 + 1).astype(np.float32)
    g = RNG.standard_normal(x.shape).astype(np.float32)
    if dtype == "bf16":
        jm.bfloat16()
        tm.bfloat16()
        x = x.astype(jnp.bfloat16)
        g = g.astype(jnp.bfloat16)
    xj = Tensor(x, device="tpu", requires_grad=True)
    out = jm(xj)
    (out * Tensor(g, device="tpu")).sum().backward()
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(tdt).requires_grad_()
    tout = tm(xt)
    (tout * torch.from_numpy(np.asarray(g, np.float32)).to(tdt)).sum().backward()
    assert tout.dtype == tdt
    tol = TOL[dtype]
    pairs = [(tout, out), (xt.grad, xj.grad)]
    if affine:
        pairs += [(tm.weight.grad, jm.weight.grad), (tm.bias.grad, jm.bias.grad)]
    for a, b in pairs:
        b = b.numpy() if hasattr(b, "numpy") else np.asarray(b.array)
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="divisible"):
        nn.GroupNorm(3, 8, device="cpu")
