"""The port's remat (``nn.Remat``, ``nn.remat_call`` and the models'
``remat=True``) against the same modules without it, on the CPU.

A rematerialised block must give the same output, gradients and buffers as
the plain block: its forward runs twice (once in backward), yet
BatchNorm's EMA is applied once, and the recompute draws the same dropout
mask from the package generator, which it leaves where the plain run
leaves it.  In eval mode, or with gradients off, remat is a pass-through
that runs the block once.  EncoderBlock, LlamaBlock and MixtralBlock (with
MoECriterion's auxiliary losses) and ResNet-18 with ``remat=True`` equal
``remat=False`` over whole training steps.  Tolerance: rtol 1e-6 and atol
1e-6 (one computation done twice in the same order; the running
statistics are bitwise equal).
"""

import numpy as np
import pytest
import torch

import deepflows_tpu_torch as dt
from deepflows_tpu_torch import nn, ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.models import EncoderBlock, LlamaBlock, MixtralBlock, ResNet18
from deepflows_tpu_torch.random import generator

RNG = np.random.default_rng(23)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    yield
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


class _Counted(nn.Module):
    """conv → BN → ReLU → dropout, counting its forwards."""

    def __init__(self, p=0.0):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1, device="cpu")
        self.bn = nn.BatchNorm2d(4, device="cpu")
        self.drop = nn.Dropout(p) if p else None
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        out = nn.functional.relu(self.bn(self.conv(x)))
        return self.drop(out) if self.drop is not None else out


def _run(block, x, remat, steps=2):
    """``steps`` forward/backward passes; outputs, gradients, buffers."""
    outs, grads = [], []
    for _ in range(steps):
        xi = x.clone().requires_grad_()
        out = nn.Remat(block)(xi) if remat else block(xi)
        (out * out).sum().backward()
        outs.append(out.detach())
        grads.append([xi.grad] + [p.grad.clone() for p in block.parameters()])
        block.zero_grad()
    return outs, grads, [b.clone() for b in block.buffers()]


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_remat_block_equals_plain(p):
    x = torch.from_numpy(RNG.standard_normal((2, 3, 5, 5)).astype(np.float32))
    dt.manual_seed(4)
    plain = _Counted(p)
    twin = _Counted(p)
    twin.load_state_dict(plain.state_dict())
    dt.manual_seed(9)
    want = _run(plain, x, remat=False)
    state_plain = generator("cpu").get_state()
    dt.manual_seed(9)
    got = _run(twin, x, remat=True)
    assert plain.calls == 2 and twin.calls == 4  # each remat step recomputes once
    assert torch.equal(generator("cpu").get_state(), state_plain)
    for a, b in zip(got[0], want[0]):
        torch.testing.assert_close(a, b, **TOL)
    for ga, gb in zip(got[1], want[1]):
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(got[2], want[2]):  # the EMA ran once a step
        assert torch.equal(a, b)


def test_remat_is_a_pass_through_in_eval_and_without_grad():
    block = _Counted(0.5)
    x = torch.ones(1, 3, 4, 4)
    wrapped = nn.Remat(block)
    assert list(wrapped.state_dict()) == ["module." + k for k in block.state_dict()]
    with torch.no_grad():
        wrapped(x)
    assert block.calls == 1
    block.eval()
    before = [b.clone() for b in block.buffers()]
    out = wrapped(x.requires_grad_())
    out.sum().backward()
    assert block.calls == 2  # no recompute
    assert all(torch.equal(a, b) for a, b in zip(block.buffers(), before))


def _block(kind, remat):
    dt.manual_seed(2)
    if kind == "encoder":
        return EncoderBlock(16, 2, dropout=0.1, device="cpu", remat=remat)
    if kind == "llama":
        return LlamaBlock(16, 4, 2, 24, device="cpu", remat=remat, window=3)
    return MixtralBlock(16, 4, 2, 24, 4, 2, device="cpu", remat=remat)


class _Mean(nn.Module):
    def forward(self, out, y):
        return (out.float() - y).pow(2).mean()


@pytest.mark.parametrize("kind", ["encoder", "llama", "mixtral"])
def test_blocks_with_remat_equal_without(kind):
    """Three whole steps (Adam) of the block with and without remat from the
    same weights and the same dropout stream: losses and weights equal."""
    x = torch.from_numpy(RNG.standard_normal((2, 6, 16)).astype(np.float32))
    y = torch.from_numpy(RNG.standard_normal((2, 6, 16)).astype(np.float32))
    runs = []
    for remat in (False, True):
        block = _block(kind, remat)
        crit = nn.MoECriterion(_Mean(), block) if kind == "mixtral" else _Mean()
        step = CompiledTrainStep(block, optim.Adam(block.parameters(), lr=1e-2), crit)
        dt.manual_seed(8)
        losses = [float(step(x, y)) for _ in range(3)]
        runs.append((losses, {k: v.clone() for k, v in block.state_dict().items()}))
    (want, wsd), (got, gsd) = runs
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for k in wsd:
        torch.testing.assert_close(gsd[k], wsd[k], **TOL)


def test_resnet18_remat_equals_plain():
    """Two SGD steps of ResNet-18 (small input) with and without remat: the
    losses, weights and running statistics agree."""
    x = RNG.standard_normal((4, 3, 8, 8)).astype(np.float32)
    y = RNG.integers(0, 10, 4).astype(np.int32)
    runs = []
    for remat in (False, True):
        dt.manual_seed(6)
        m = ResNet18(num_classes=10, small_input=True, device="cpu", remat=remat)
        step = CompiledTrainStep(m, optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
                                 nn.CrossEntropyLoss())
        runs.append(([float(step(x, y)) for _ in range(2)], m.state_dict()))
    (want, wsd), (got, gsd) = runs
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for k in wsd:
        torch.testing.assert_close(gsd[k], wsd[k], **TOL)
