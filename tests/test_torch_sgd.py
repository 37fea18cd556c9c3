"""The port's SGD (plain, momentum, nesterov, weight decay) against the JAX
package's ``pure_update`` over 5 steps of the same numpy parameters and
gradients, one gradient None; and ``load_jax_optimizer_state`` with SGD's
state (``{"v": [...]}``, ``{"v": None}`` without momentum): a JAX SGD run
of MNIST_CNN resumed in the port matches the JAX run continued for 2
further steps.  Tolerances: f32 rtol 1e-6 and atol 1e-7 for the update;
losses rtol 1e-4 and weights rtol 1e-4 / atol 1e-5 for the resumed run.
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
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.models import MNIST_CNN
from deepflows_tpu_torch.utils import load_jax_optimizer_state, load_jax_state_dict

RNG = np.random.default_rng(17)
SHAPES = ((4, 3), (5,), (2, 3, 3, 3))
CONFIGS = {
    "plain": dict(),
    "momentum": dict(momentum=0.9),
    "nesterov": dict(momentum=0.9, nesterov=True),
    "weight_decay": dict(weight_decay=1e-2),
    "all": dict(momentum=0.8, nesterov=True, weight_decay=5e-4),
}


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_sgd_pure_update_matches_jax(cfg):
    kw = CONFIGS[cfg]
    params = [RNG.standard_normal(s).astype(np.float32) for s in SHAPES]
    jopt = joptim.SGD([Tensor(p, device="tpu") for p in params], lr=0.05, **kw)
    topt = optim.SGD([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params],
                     lr=0.05, **kw)
    jstate, tstate = jopt.init_state(), topt.init_state()
    assert (jstate["v"] is None) == (tstate["v"] is None) == ("momentum" not in kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    for step in range(5):
        grads = [RNG.standard_normal(s).astype(np.float32) for s in SHAPES]
        grads[1] = None if step == 2 else grads[1]  # a parameter without a gradient
        jp, jstate = jopt.pure_update(
            jp, [None if g is None else jnp.asarray(g) for g in grads], jstate, 0.05)
        tp, tstate = topt.pure_update(
            tp, [None if g is None else torch.from_numpy(g) for g in grads], tstate, 0.05)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        if jstate["v"] is not None:
            for a, b in zip(tstate["v"], jstate["v"]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_sgd_resume_from_jax(momentum):
    """Two JAX steps, then weights and SGD state across to the port; two
    more steps on each side agree."""
    df.manual_seed(5)
    jm = jmodels.MNIST_CNN(device="tpu")
    jstep = JaxStep(jm, joptim.SGD(jm.parameters(), lr=0.05, momentum=momentum),
                    jnn.CrossEntropyLoss())
    batches = [(RNG.standard_normal((4, 1, 28, 28)).astype(np.float32),
                RNG.integers(0, 10, 4).astype(np.int32)) for _ in range(4)]
    for x, y in batches[:2]:
        jstep(x, y)
    tm = MNIST_CNN(device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    topt = optim.SGD(tm.parameters(), lr=0.05, momentum=momentum)
    jstate = jstep.optimizer.state_dict()["state"]
    load_jax_optimizer_state(
        topt, {"v": None if jstate["v"] is None else [np.asarray(v) for v in jstate["v"]]})
    assert (topt._state["v"] is None) == (momentum == 0.0)
    tstep = CompiledTrainStep(tm, topt, tnn.CrossEntropyLoss())
    for x, y in batches[2:]:
        np.testing.assert_allclose(float(tstep(x, y)), float(jstep(x, y)), rtol=1e-4)
    tsd = tm.state_dict()
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_load_sgd_state_refuses_a_mismatch():
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="None"):
        load_jax_optimizer_state(optim.SGD([p], momentum=0.9), {"v": None})
    with pytest.raises(ValueError):
        load_jax_optimizer_state(optim.SGD([p]), {"v": [np.zeros(3)]})
    with pytest.raises(KeyError):
        load_jax_optimizer_state(optim.SGD([p], momentum=0.9),
                                 {"v": [np.zeros(3)], "s": [np.zeros(3)], "t": 1})
    with pytest.raises(ValueError, match="shape"):
        load_jax_optimizer_state(optim.SGD([p], momentum=0.9), {"v": [np.zeros(4)]})
