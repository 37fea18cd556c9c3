"""The port's ``Trainer`` against the JAX package's on the CPU: the same
small MLP (weights carried across by ``load_jax_state_dict``), the same
batches (``shuffle=False``: ``fit`` seeds no shuffle), Adam and a cosine
schedule; ``history["loss"]`` within 1e-5 relative over 3 epochs, the
test accuracy and the lr equal; early stop at ``target_acc`` after the
same epoch; the checkpoint written each epoch loads in the JAX package
equal to the port's weights and Adam state; ``augment_fn`` runs on the
prefetch thread; an injected step is used; ``evaluate`` equals JAX's.
"""

import threading

import numpy as np
import pytest

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu import utils as jutils
from deepflows_tpu_torch import nn, ops, optim, utils
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(7)
X = RNG.standard_normal((192, 12)).astype(np.float32)
W = RNG.standard_normal((12, 3)).astype(np.float32)
Y = (X @ W).argmax(1).astype(np.int32)
XT, YT = X[:100], Y[:100]
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found it."""
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
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)


def _mlp(pkg, device):
    return pkg.Sequential(pkg.Linear(12, 16, device=device), pkg.ReLU(),
                          pkg.Linear(16, 3, device=device))


def _pair(lr=0.02, fused=False):
    df.manual_seed(3)
    jm = _mlp(jnn, "cpu")
    tm = load_jax_state_dict(_mlp(nn, "cpu"), jm.state_dict())
    jopt = joptim.Adam(jm.parameters(), lr=lr)
    topt = optim.Adam(tm.parameters(), lr=lr, fused=fused)
    return (jm, jopt), (tm, topt)


def _trainers(tmp_path=None, **kw):
    (jm, jopt), (tm, topt) = _pair(**kw)
    jlog, tlog = [], []
    ck = {} if tmp_path is None else {"j": str(tmp_path / "jax.pkl"),
                                      "t": str(tmp_path / "port.pkl")}
    jt = jutils.Trainer(jm, jopt, jnn.CrossEntropyLoss(),
                        scheduler=joptim.CosineAnnealingLR(jopt, T_max=4),
                        checkpoint_path=ck.get("j"), log_fn=jlog.append)
    tt = utils.Trainer(tm, topt, nn.CrossEntropyLoss(),
                       scheduler=optim.CosineAnnealingLR(topt, T_max=4),
                       checkpoint_path=ck.get("t"), log_fn=tlog.append)
    return jt, tt, jlog, tlog, ck


def _same_history(th, jh):
    assert len(th["loss"]) == len(jh["loss"])
    for got, want in zip(th["loss"], jh["loss"]):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (th["loss"], jh["loss"])
    assert th["test_acc"] == jh["test_acc"]
    assert th["lr"] == pytest.approx(jh["lr"], rel=1e-12)
    assert len(th["epoch_time"]) == len(jh["epoch_time"])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_history_matches_jax(tmp_path, fused, prefetch):
    jt, tt, jlog, tlog, ck = _trainers(tmp_path, fused=fused)
    kw = dict(epochs=3, batch_size=32, shuffle=False, prefetch_size=prefetch,
              eval_batch_size=64)
    jh = jt.fit(X, Y, XT, YT, **kw)
    th = tt.fit(X, Y, XT, YT, **kw)
    _same_history(th, jh)
    assert th["loss"][-1] < th["loss"][0]
    assert len(tlog) == len(jlog) == 3 and tlog[0].startswith("epoch 0: loss=")
    # the last epoch's checkpoint, read by the JAX package
    df.manual_seed(11)
    jm2 = _mlp(jnn, "cpu")
    jopt2 = joptim.Adam(jm2.parameters(), lr=0.5)
    info = jutils.load_checkpoint(jm2, jopt2, ck["t"])
    assert info["epoch"] == 2 and info["loss"] == pytest.approx(th["loss"][-1], rel=1e-7)
    for name, arr in jm2.state_dict().items():
        np.testing.assert_array_equal(arr, tt.model.state_dict()[name].numpy(), err_msg=name)
    jstate = jopt2.state_dict()["state"]
    for k in ("v", "s"):
        for a, b in zip(jstate[k], tt.optimizer._state[k]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(jstate["t"])) == 3 * (len(X) // 32)


def test_early_stop_after_the_same_epoch():
    jt, tt, jlog, tlog, _ = _trainers(lr=0.05)
    kw = dict(epochs=30, batch_size=32, shuffle=False, target_acc=93.0)
    jh = jt.fit(X, Y, XT, YT, **kw)
    th = tt.fit(X, Y, XT, YT, **kw)
    _same_history(th, jh)
    assert len(th["loss"]) < 30 and th["test_acc"][-1] * 100 >= 93.0
    assert tlog[-1] == jlog[-1] == "early stop at target accuracy 93.0%"


def test_evaluate_matches_jax():
    jt, tt, *_ = _trainers()
    for bs in (7, 64, 1000):
        assert tt.evaluate(XT, YT, batch_size=bs) == jt.evaluate(XT, YT, batch_size=bs)


def test_augment_runs_on_the_prefetch_thread_and_steps_can_be_injected():
    (_, _), (tm, topt) = _pair()
    main, seen, calls = threading.get_ident(), [], []

    def augment(x):
        seen.append(threading.get_ident())
        return x * 1.0

    inner = CompiledTrainStep(tm, topt, nn.CrossEntropyLoss())

    def step(x, y):  # an injected step; the batches arrive as CPU tensors
        calls.append((type(x).__name__, x.device.type))
        return inner(x, y)

    tr = utils.Trainer(tm, topt, nn.CrossEntropyLoss(), augment_fn=augment, step=step,
                       log_fn=lambda s: None)
    hist = tr.fit(X, Y, epochs=2, batch_size=64, shuffle=True, prefetch_size=2)
    assert len(calls) == 2 * 3 and set(calls) == {("Tensor", "cpu")}
    assert seen and all(t != main for t in seen)
    assert np.isnan(hist["test_acc"]).all() and len(hist["loss"]) == 2


def test_mesh_steps_get_host_batches():
    """A step with a ``mesh`` attribute (the sharded steps) places host
    batches itself: the Trainer stages nothing for it."""
    (_, _), (tm, topt) = _pair()
    inner = CompiledTrainStep(tm, topt, nn.CrossEntropyLoss())
    kinds = []

    class MeshStep:
        mesh = object()

        def __call__(self, x, y):
            kinds.append(type(x).__name__)
            return inner(x, y)

    tr = utils.Trainer(tm, topt, nn.CrossEntropyLoss(), step=MeshStep(), log_fn=lambda s: None)
    tr.fit(X, Y, epochs=1, batch_size=64, shuffle=False)
    assert kinds == ["ndarray"] * 3
