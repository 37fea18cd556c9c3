"""The rest of nn's public surface in the port against the JAX package on the
CPU: ``nn.Parameter``; the containers ``Sequential``, ``ModuleList`` and
``ModuleDict`` (indexing, negative and slice indices, deletion and its
renumbering, append / extend / insert / ``+=`` / ``+``, and the state_dict
keys each leaves, held key for key against the same operations in JAX);
``nn.init``'s fill functions exactly, its fans against JAX's (the ``(in,
out)`` Linear weight's fan-in is ``shape[1]`` in both), and the xavier and
kaiming draws' std within 10% of the formula on a 512 × 256 tensor
(fan-in 256, fan-out 512, so the convention shows); the
losses ``l1_loss``, ``mse_loss``, ``nll_loss`` and ``binary_cross_entropy``
and their modules against JAX's on the same numpy inputs in every
reduction, values and input gradients within 1e-6 (f32); ``one_hot``.
"""

import copy
import math
from collections import OrderedDict

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu_torch import nn, ops
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(23)
TOL = 1e-6


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
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


# ----------------------------------------------------------------- Parameter
def test_parameter_requires_grad_under_no_grad():
    with torch.no_grad():
        p = nn.Parameter(torch.zeros(3))
        q = nn.Parameter(np.ones((2, 2)))
    assert p.requires_grad and q.requires_grad
    assert isinstance(p, torch.nn.Parameter) and q.dtype == torch.float32
    with torch.inference_mode(False), torch.no_grad():
        m = nn.Linear(2, 2, device="cpu").eval()
        m.extra = nn.Parameter(torch.ones(2))
    assert "extra" in dict(m.named_parameters()) and m.extra.requires_grad
    p.requires_grad_(False)
    c = copy.deepcopy(p)
    assert type(c) is nn.Parameter and not c.requires_grad
    assert nn.Parameter().shape == (0,)


# ---------------------------------------------------------------- containers
def _layers(pkg, n=4):
    return [pkg.Linear(2 + i, 3 + i, device="cpu") for i in range(n)]


def _keys(module):
    return list(module.state_dict().keys())


SEQ_OPS = {
    "negative": lambda s, pkg: s[-1],
    "slice": lambda s, pkg: s[1:3],
    "slice_step": lambda s, pkg: s[::2],
    "setitem": lambda s, pkg: s.__setitem__(-2, pkg.Linear(9, 9, device="cpu")),
    "delitem": lambda s, pkg: s.__delitem__(1),
    "del_slice": lambda s, pkg: s.__delitem__(slice(0, 2)),
    "append": lambda s, pkg: s.append(pkg.Linear(7, 7, device="cpu")),
    "extend": lambda s, pkg: s.extend(pkg.Sequential(pkg.Linear(5, 5, device="cpu"))),
    "add": lambda s, pkg: s + pkg.Sequential(pkg.Linear(5, 5, device="cpu")),
    "ordered_dict": lambda s, pkg: pkg.Sequential(
        OrderedDict([("a", pkg.Linear(2, 2, device="cpu")), ("b", pkg.ReLU())])),
}


@pytest.mark.parametrize("op", list(SEQ_OPS))
def test_sequential_ops_match_jax(op):
    """The same operation on a Sequential of four Linears in both packages:
    the same result's keys and widths, and the container's keys after."""
    got = {}
    for pkg in (jnn, nn):
        s = pkg.Sequential(*_layers(pkg))
        out = SEQ_OPS[op](s, pkg)
        if op == "delitem":
            assert len(s) == 3 and list(s._modules) == ["0", "2", "3"]
        got[pkg] = (_keys(s), _keys(out) if out is not None else None,
                    [tuple(p.shape) for p in (out or s).parameters()])
    assert got[nn] == got[jnn]


def test_sequential_index_errors_and_forward():
    s = nn.Sequential(*_layers(nn, 2))
    with pytest.raises(IndexError):
        s[2]
    with pytest.raises(IndexError):
        s[-3]
    with pytest.raises(ValueError):
        s + nn.ModuleList()
    x = torch.ones(1, 2)
    assert s(x).shape == (1, 4) and len(s) == 2 and list(s) == [s[0], s[1]]


LIST_OPS = {
    "negative": lambda m, pkg: m[-2],
    "slice": lambda m, pkg: m[1:],
    "setitem": lambda m, pkg: m.__setitem__(-1, pkg.Linear(9, 9, device="cpu")),
    "delitem": lambda m, pkg: m.__delitem__(1),
    "del_negative": lambda m, pkg: m.__delitem__(-4),
    "del_slice": lambda m, pkg: m.__delitem__(slice(1, 3)),
    "insert": lambda m, pkg: m.insert(1, pkg.Linear(8, 8, device="cpu")),
    "iadd": lambda m, pkg: m.__iadd__([pkg.Linear(6, 6, device="cpu")]),
    "append": lambda m, pkg: m.append(pkg.Linear(7, 7, device="cpu")),
    "extend": lambda m, pkg: m.extend(_layers(pkg, 2)),
}


@pytest.mark.parametrize("op", list(LIST_OPS))
def test_module_list_ops_match_jax(op):
    """The same operation on a ModuleList of four Linears in both packages:
    keys stay 0..n-1 after a deletion (renumbered), and the widths at each
    index agree."""
    got = {}
    for pkg in (jnn, nn):
        m = pkg.ModuleList(_layers(pkg))
        out = LIST_OPS[op](m, pkg)
        got[pkg] = (_keys(m), [tuple(p.weight.shape) for p in m],
                    _keys(out) if isinstance(out, pkg.Module) else None)
    assert got[nn] == got[jnn]
    assert [k.split(".")[0] for k in got[nn][0][::2]] == [str(i) for i in range(len(got[nn][1]))]


def test_module_list_errors():
    m = nn.ModuleList(_layers(nn, 2))
    with pytest.raises(IndexError):
        m[2]
    with pytest.raises(IndexError):
        del m[-3]
    assert len(nn.ModuleList()) == 0


def test_module_dict_matches_jax():
    got = {}
    for pkg in (jnn, nn):
        d = pkg.ModuleDict({"enc": pkg.Linear(2, 3, device="cpu"),
                            "dec": pkg.Linear(3, 2, device="cpu")})
        d["head"] = pkg.Linear(2, 5, device="cpu")
        d.update({"aux": pkg.ReLU()})
        del d["enc"]
        assert "dec" in d and "enc" not in d and len(d) == 3
        assert list(d) == list(d.keys()) == ["dec", "head", "aux"]
        assert [v for _, v in d.items()] == list(d.values())
        assert isinstance(d["head"], pkg.Linear)
        got[pkg] = _keys(d)
    assert got[nn] == got[jnn] == ["dec.weight", "dec.bias", "head.weight", "head.bias"]


class _Nested:
    """The same nested model in either package: a Sequential, a ModuleList
    of Sequentials and a ModuleDict, edited after construction."""

    @staticmethod
    def build(pkg):
        class Net(pkg.Module):
            def __init__(self):
                super().__init__()
                self.stem = pkg.Sequential(pkg.Linear(6, 8, device="cpu"), pkg.ReLU())
                self.blocks = pkg.ModuleList(
                    [pkg.Sequential(pkg.Linear(8, 8, device="cpu"), pkg.Tanh())
                     for _ in range(3)])
                self.heads = pkg.ModuleDict({"a": pkg.Linear(8, 2, device="cpu"),
                                             "b": pkg.Linear(8, 3, device="cpu")})
                del self.blocks[0]
                self.blocks.insert(1, pkg.Sequential(pkg.Linear(8, 8, device="cpu")))
                self.stem.append(pkg.Linear(8, 8, device="cpu"))

            def forward(self, x):
                x = self.stem(x)
                for blk in self.blocks:
                    x = blk(x)
                return self.heads["a"](x), self.heads["b"](x)

        return Net()


def test_nested_state_dict_keys_and_forward_match_jax():
    df.manual_seed(1)
    jm, tm = _Nested.build(jnn), _Nested.build(nn)
    assert _keys(tm) == _keys(jm)
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]
    load_jax_state_dict(tm, jm.state_dict())
    x = RNG.standard_normal((4, 6)).astype(np.float32)
    for j, t in zip(jm(Tensor(x, device="cpu")), tm(torch.as_tensor(x))):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), rtol=1e-5, atol=1e-6)


def test_cnn_mlp_keys_unchanged():
    """models.MLP on the port's ModuleList keeps the JAX package's keys."""
    from deepflows_tpu import models as jmodels
    from deepflows_tpu_torch import models

    assert isinstance(models.MLP(device="cpu").layers, nn.ModuleList)
    assert _keys(models.MLP(device="cpu")) == _keys(jmodels.MLP(device="cpu"))


# ----------------------------------------------------------------------- init
@pytest.mark.parametrize("fn,args,want", [
    ("fill_", (2.5,), 2.5), ("zeros_", (), 0.0), ("ones_", (), 1.0), ("constant_", (-3.0,), -3.0),
])
def test_fill_functions_exact(fn, args, want):
    t = torch.randn(3, 4)
    out = getattr(nn.init, fn)(t, *args)
    assert out is t and torch.equal(t, torch.full((3, 4), want))
    p = nn.Linear(3, 4, device="cpu").weight
    getattr(nn.init, fn)(p, *args)  # a leaf that requires grad fills under no_grad
    assert torch.equal(p.detach(), torch.full((3, 4), want)) and p.requires_grad


@pytest.mark.parametrize("shape", [(4, 5), (5, 4), (8, 3, 3, 3), (2, 5, 7)])
def test_fans_equal_jax(shape):
    want = jnn.init._calculate_fan_in_and_fan_out(Tensor(np.zeros(shape, np.float32),
                                                         device="cpu"))
    assert nn.init._calculate_fan_in_and_fan_out(torch.zeros(shape)) == want
    for mode in ("fan_in", "fan_out"):
        assert nn.init._calculate_correct_fan(torch.zeros(shape), mode) == \
            jnn.init._calculate_correct_fan(Tensor(np.zeros(shape, np.float32), device="cpu"),
                                            mode)


def test_fan_errors():
    with pytest.raises(ValueError, match="fewer than 2"):
        nn.init._calculate_fan_in_and_fan_out(torch.zeros(3))
    with pytest.raises(ValueError, match="Mode"):
        nn.init.kaiming_normal_(torch.zeros(4, 4), mode="fan_avg")


INIT_STD = {  # name, kwargs, the std of the distribution on a (512, 256) tensor
    "xavier_uniform_": ({"gain": 2.0}, 2.0 * math.sqrt(2.0 / (256 + 512))),
    "xavier_normal_": ({}, math.sqrt(2.0 / (256 + 512))),
    "kaiming_uniform_": ({"nonlinearity": "relu"}, math.sqrt(2.0) / math.sqrt(256)),
    "kaiming_normal_": ({"nonlinearity": "relu"}, math.sqrt(2.0) / math.sqrt(256)),
    "kaiming_normal_(fan_out)": ({"mode": "fan_out", "a": 0.2}, math.sqrt(2.0 / 1.04) / math.sqrt(512)),
}


@pytest.mark.parametrize("name", list(INIT_STD))
def test_random_init_std_and_generator(name):
    """The draw's std within 10% of the formula (fan-in = shape[1] = 256,
    JAX's convention), and the same draw again after reseeding the port's
    generator: every init draws from it, not from torch's global one."""
    kw, std = INIT_STD[name]
    fn = getattr(nn.init, name.split("(")[0])
    dt.manual_seed(5)
    t = fn(torch.empty(512, 256), **kw)
    assert abs(float(t.std()) / std - 1.0) < 0.1
    torch.manual_seed(123)  # the global generator plays no part
    dt.manual_seed(5)
    assert torch.equal(fn(torch.empty(512, 256), **kw), t)
    if "uniform" in name:
        assert float(t.abs().max()) <= math.sqrt(3.0) * std * (1 + 1e-6)


# --------------------------------------------------------------------- losses
def _loss_inputs(name, target_kind):
    if name == "bce":
        x = RNG.uniform(0.02, 0.98, (5, 4)).astype(np.float32)
        x[0, :2] = (0.0, 1.0)  # clamped: no gradient
        t = RNG.uniform(0.0, 1.0, (5, 4)).astype(np.float32)
        return x, t
    if name == "nll":
        x = RNG.standard_normal((6, 5)).astype(np.float32)
        if target_kind == "int3d":
            x = RNG.standard_normal((3, 5, 4)).astype(np.float32)
            return x, RNG.integers(0, 5, (3, 4))
        t = RNG.integers(0, 5, (6,))
        return x, (np.eye(5, dtype=np.float32)[t] if target_kind == "onehot" else t)
    return (RNG.standard_normal((4, 3, 2)).astype(np.float32),
            RNG.standard_normal((4, 3, 2)).astype(np.float32))


LOSSES = {"l1": ("l1_loss", "L1Loss"), "mse": ("mse_loss", "MSELoss"),
          "nll": ("nll_loss", "NLLLoss"), "bce": ("binary_cross_entropy", "BCELoss")}
LOSS_CASES = [(n, r, k) for n in LOSSES for r in ("mean", "sum", "none")
              for k in (("int", "onehot", "int3d") if n == "nll" else ("float",))]


@pytest.mark.parametrize("name,reduction,target_kind", LOSS_CASES)
def test_losses_match_jax(name, reduction, target_kind):
    """The functional loss and its module against JAX's on the same inputs:
    values, and the input's gradient (through the sum of the loss times
    random weights under ``"none"``), within 1e-6."""
    fname, mname = LOSSES[name]
    x, t = _loss_inputs(name, target_kind)
    jx = Tensor(x, device="cpu", requires_grad=True)
    jl = getattr(jnn.functional, fname)(jx, Tensor(t, device="cpu"), reduction=reduction)
    tx = torch.tensor(x, requires_grad=True)
    tl = getattr(nn.functional, fname)(tx, t, reduction=reduction)
    mod = getattr(nn, mname)(reduction=reduction)(tx, torch.as_tensor(t))
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), rtol=TOL, atol=TOL)
    assert torch.equal(mod, tl)
    if reduction == "none":
        w = RNG.standard_normal(jl.shape).astype(np.float32)
        jl = (jl * Tensor(w, device="cpu")).sum()
        tl = (tl * torch.as_tensor(w)).sum()
    jl.backward()
    tl.backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=TOL, atol=TOL)
    if name == "bce":
        assert tx.grad[0, 0] == 0 and tx.grad[0, 1] == 0  # clamped to [eps, 1 - eps]


def test_nll_is_the_reference_definition():
    """``nll_loss`` means over every element of -input · onehot, not over
    the targets as torch's does."""
    x = torch.randn(4, 3)
    t = torch.tensor([0, 2, 1, 2])
    want = -x[torch.arange(4), t].sum() / x.numel()
    torch.testing.assert_close(nn.functional.nll_loss(x, t), want)


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_reduction_is_checked(name):
    with pytest.raises(ValueError, match="reduction"):
        getattr(nn, LOSSES[name][1])(reduction="avg")
    with pytest.raises(AssertionError):
        getattr(jnn, LOSSES[name][1])(reduction="avg")
    with pytest.raises(ValueError, match="reduction"):
        getattr(nn.functional, LOSSES[name][0])(torch.ones(2, 2), torch.ones(2, 2),
                                                reduction="avg")


def test_one_hot_matches_jax():
    idx = RNG.integers(0, 6, (3, 4))
    want = jnn.functional.one_hot(idx, 6, device="cpu").numpy()
    for got in (nn.functional.one_hot(idx, 6, device="cpu"),
                nn.functional.one_hot(torch.as_tensor(idx), 6)):
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_array_equal(got.numpy(), want)
