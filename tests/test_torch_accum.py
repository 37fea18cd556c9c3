"""The port's ``CompiledTrainStep(accum_steps=N)``, its ``metrics_fn`` and
the ``jit()`` decorator against the JAX package on the CPU.

- accum_steps 2 and 4 against the JAX package's scanned step (its
  ``lax.scan`` over the microbatches), on a Linear → BatchNorm1d → ReLU →
  Linear model, so that BN's EMA runs once a microbatch, with a "mean"
  and a "sum" criterion (the sum's gradients are not divided by N): the
  losses, every weight and both running statistics over 3 SGD steps,
  and the per-microbatch accuracy averaged into ``_last_metrics``;
- accum_steps 4 against 1 in the port on a model without BN: one update
  of the mean loss's gradient either way;
- ``jit(fn)``: the JAX test's fused accuracy, gradients off inside and the
  caller's mode kept.

Tolerances: losses rtol 1e-4, weights and statistics rtol 1e-4 / atol
1e-5 (tests/test_torch_sgd.py's resume bound); accum 4 against 1 rtol
1e-5 / atol 1e-6 (f32, sums in another order).
"""

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import Graph
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu.jit import jit as jax_jit
from deepflows_tpu_torch import nn, ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep, jit
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(43)


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


def _pair(seed):
    df.manual_seed(seed)
    jm = jnn.Sequential(jnn.Linear(6, 16, device="cpu"), jnn.BatchNorm1d(16, device="cpu"),
                        jnn.ReLU(), jnn.Linear(16, 3, device="cpu"))
    tm = nn.Sequential(nn.Linear(6, 16, device="cpu"), nn.BatchNorm1d(16, device="cpu"),
                       nn.ReLU(), nn.Linear(16, 3, device="cpu"))
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, tm


def _jacc(out, yt):
    return {"acc": (out.data.array.argmax(1) == yt.data.array).mean()}


def _tacc(out, y):
    return {"acc": (out.argmax(1) == y).float().mean()}


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("n", [2, 4])
def test_accum_steps_match_jax_scan(n, reduction):
    jm, tm = _pair(9)
    # SGD, not Adam: the bias in front of BN has a gradient of rounding
    # noise only, which Adam's first steps would blow up to ±lr.  The sum
    # over the batch of 16 takes a 16th of the mean's lr: the same step.
    lr = 0.1 if reduction == "mean" else 0.1 / 16
    jstep = JaxStep(jm, joptim.SGD(jm.parameters(), lr=lr, momentum=0.9),
                    jnn.CrossEntropyLoss(reduction=reduction), accum_steps=n, metrics_fn=_jacc)
    tstep = CompiledTrainStep(tm, optim.SGD(tm.parameters(), lr=lr, momentum=0.9),
                              nn.CrossEntropyLoss(reduction=reduction), accum_steps=n,
                              metrics_fn=_tacc)
    for _ in range(3):
        x = (RNG.standard_normal((16, 6)) * 2 + 0.5).astype(np.float32)
        y = RNG.integers(0, 3, 16).astype(np.int32)
        np.testing.assert_allclose(float(tstep(x, y)), float(jstep(x, y)), rtol=1e-4)
        np.testing.assert_allclose(float(tstep._last_metrics["acc"]),
                                   float(jstep._last_metrics["acc"]), rtol=1e-6)
    tsd = tm.state_dict()
    for k, v in jm.state_dict().items():  # running_mean and running_var too
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_accum_four_is_one_update_of_the_whole_batch(reduction):
    """Without BN, the four microbatches' gradients summed (and divided by
    4 for a mean) are the whole batch's: one SGD update and one loss, the
    same as accum_steps=1's."""
    models = []
    for _ in range(2):
        dt.manual_seed(3)
        models.append(nn.Sequential(nn.Linear(6, 8, device="cpu"), nn.Tanh(),
                                    nn.Linear(8, 3, device="cpu")))
    x = RNG.standard_normal((8, 6)).astype(np.float32)
    y = RNG.integers(0, 3, 8).astype(np.int32)
    losses = []
    for m, n in zip(models, (4, 1)):
        step = CompiledTrainStep(m, optim.SGD(m.parameters(), lr=0.1),
                                 nn.CrossEntropyLoss(reduction=reduction), accum_steps=n)
        losses.append(float(step(x, y)))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for a, b in zip(*(m.parameters() for m in models)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_function_jit_matches_jax():
    calls = {"n": 0}

    def accuracy(logits, labels, F):
        calls["n"] += 1
        p = F.softmax(logits, 1)
        return (p.argmax(1) == labels).float().mean() if F is nn.functional else (
            p.argmax(1).eq(labels)).mean()

    from deepflows_tpu import Tensor
    from deepflows_tpu.nn import functional as JF

    logits = RNG.standard_normal((8, 4)).astype(np.float32)
    labels = RNG.integers(0, 4, 8).astype(np.float32)
    want = float(jax_jit(lambda lo, la: accuracy(lo, Tensor(la.data), JF))(logits, labels))
    fused = jit(lambda lo, la: accuracy(lo, la, nn.functional))
    x = torch.from_numpy(logits).requires_grad_()
    got = fused(x, labels)  # numpy labels go to the logits' device
    assert float(got) == want == (logits.argmax(1) == labels).mean()
    assert not got.requires_grad and torch.is_grad_enabled()
    assert fused.__wrapped__ is not None and calls["n"] == 2
