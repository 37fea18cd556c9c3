"""The tape slice as a whole on the CPU, the port against the JAX package:
the reference's training loop (``model(Tensor(x))``, the criterion,
``zero_grad``, ``backward``, ``step``) on a small ``models.MLP`` (32-16-10,
B 8) under ``use_pallas`` in both packages, the JAX side on its JAX device
with its Pallas kernels in interpret mode and the port's weights loaded
from it (``load_jax_state_dict``); a raw-tape MLP written with tape ops
only (SGD through ``.data`` under ``no_grad``), whose 8 products a step
take ``ops.matmul``; ``Module.eval()`` stopping the tape in both while a
plain-tensor forward of the port still builds torch's graph; and a
reference-style script run through ``python -m deepflows_tpu_torch.shim``.

Tolerances: losses and weights within 1e-5 (relative, 1e-6 absolute).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu_torch import config as tconfig
from deepflows_tpu_torch import models as tmodels
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import optim as toptim
from deepflows_tpu_torch.utils import load_jax_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
WIDTHS = (32, 16, 10)
RAW_WIDTHS = (32, 16, 12, 10)  # three layers, as the reference MLP has
B, STEPS, LR = 8, 3, 0.1


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state and both packages'
    ``use_pallas`` as this module found them."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = config.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    pallas = (config.use_pallas, tconfig.use_pallas)
    yield
    config.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager
    config.use_pallas, tconfig.use_pallas = pallas


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both tapes empty and recording (the JAX ``Module.eval()`` flips its
    flag process-wide), ``use_pallas`` off, around each test; a Tensor made
    without ``device=`` on the CPU (the port's default is the card)."""
    from deepflows_tpu import config

    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")

    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    yield
    config.use_pallas = tconfig.use_pallas = False
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)


def _use_pallas(on: bool):
    from deepflows_tpu import config

    config.use_pallas = tconfig.use_pallas = on


def _batches():
    r = np.random.default_rng(17)
    teacher = r.standard_normal((WIDTHS[0], WIDTHS[-1])).astype(np.float32)
    xs = r.random((STEPS, B, WIDTHS[0]), dtype=np.float32)
    return xs, (xs @ teacher).argmax(-1).astype(np.int32)


def _models():
    df.manual_seed(0)
    jm = jmodels.MLP(WIDTHS[0], WIDTHS[1:-1], WIDTHS[-1], device="tpu")
    tm = tmodels.MLP(WIDTHS[0], WIDTHS[1:-1], WIDTHS[-1], device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


def _reference_loop(pkg, model, optim, nn, dev, xs, ys):
    opt = optim.Adam(model.parameters(), lr=1e-3)
    crit = nn.CrossEntropyLoss()
    losses = []
    for x, y in zip(xs, ys):
        out = model(pkg.Tensor(x, device=dev))
        loss = crit(out, pkg.Tensor(y, device=dev))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.numpy()))
        pkg.Graph.free_graph_all()
    return losses


def test_reference_loop_matches_jax():
    xs, ys = _batches()
    jm, tm = _models()
    _use_pallas(True)
    want = _reference_loop(df, jm, joptim, jnn, "tpu", xs, ys)
    got = _reference_loop(dt, tm, toptim, tnn, "cpu", xs, ys)
    np.testing.assert_allclose(got, want, **TOL)
    jsd = jm.state_dict()
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jsd[name]), **TOL, err_msg=name)


def _raw_weights(seed=5):
    r = np.random.default_rng(seed)
    out = []
    for a, b in zip(RAW_WIDTHS[:-1], RAW_WIDTHS[1:]):
        out += [(r.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                np.zeros((1, b), np.float32)]
    return out


def _raw_tape_loop(pkg, dev, xs, ys):
    """The MLP written with tape ops only: x @ w + b, maximum(h, 0), a
    log-softmax from exp, log, max and sum, the mean NLL; SGD on .data."""
    ws = [pkg.Tensor(a, device=dev, requires_grad=True) for a in _raw_weights()]
    leaves = len(pkg.Graph.node_list)
    losses = []
    for x, y in zip(xs, ys):
        h = pkg.Tensor(x, device=dev)
        for i in range(0, len(ws), 2):
            h = h @ ws[i] + ws[i + 1]
            if i + 2 < len(ws):
                h = pkg.maximum(h, 0.0)
        m = h.max(axis=1, keepdims=True)
        logp = h - m - pkg.log(pkg.exp(h - m).sum(axis=1, keepdims=True))
        onehot = np.eye(RAW_WIDTHS[-1], dtype=np.float32)[y]
        loss = -(logp * pkg.Tensor(onehot, device=dev)).sum(axis=1).mean()
        loss.backward()
        assert len(pkg.Graph.node_list) == leaves
        with pkg.no_grad():
            for w in ws:
                w.data -= LR * w.grad
                w.zero_grad()
        losses.append(float(loss.numpy()))
    return losses, [w.numpy() for w in ws]


def test_raw_tape_mlp_matches_jax_and_routes_its_products(monkeypatch):
    """Three layers (32-16-12-10): 8 ops.matmul calls a step (3 forward,
    dW of every layer, dx of the last two), counted by a wrapper: on the
    CPU the kernel's launch counter stays 0, as the plain twin launches
    nothing."""
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import linear

    calls = []
    real = linear.matmul

    def counting(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(linear, "matmul", counting)
    xs, ys = _batches()
    _use_pallas(True)
    want, want_w = _raw_tape_loop(df, "tpu", xs, ys)
    got, got_w = _raw_tape_loop(dt, "cpu", xs, ys)
    np.testing.assert_allclose(got, want, **TOL)
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert got[-1] < got[0]
    assert len(calls) == 8 * STEPS, calls
    assert ops.matmul.launches == 0
    _use_pallas(False)
    calls.clear()
    _raw_tape_loop(dt, "cpu", xs[:1], ys[:1])
    assert calls == []


def test_eval_stops_tape_recording_as_in_jax():
    xs, _ = _batches()
    jm, tm = _models()
    for pkg, model, dev in ((df, jm, "tpu"), (dt, tm, "cpu")):
        model.eval()
        nodes = len(pkg.Graph.node_list)  # the JAX package's parameters are tape leaves
        assert not pkg.is_grad_enable()
        assert not pkg.Tensor(xs[0], device=dev, requires_grad=True).requires_grad
        out = model(pkg.Tensor(xs[0], device=dev))
        assert not out.requires_grad and len(pkg.Graph.node_list) == nodes
        model.train()
        assert pkg.is_grad_enable()
    tm.eval()
    plain = tm(torch.from_numpy(xs[0]))  # torch's own grad mode is untouched
    assert plain.requires_grad and plain.grad_fn is not None
    assert type(plain) is torch.Tensor
    tm.train()


def test_compiled_step_takes_tape_tensors():
    """``CompiledTrainStep`` takes tape Tensors as they are and records
    nothing on the tape."""
    from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep

    xs, ys = _batches()
    _, tm = _models()
    step = CompiledTrainStep(tm, toptim.Adam(tm.parameters(), lr=1e-3), tnn.CrossEntropyLoss())
    loss = step(dt.Tensor(xs[0], device="cpu"), dt.Tensor(ys[0], device="cpu"))
    assert type(loss) is torch.Tensor and np.isfinite(loss.item())
    out = CompiledEvalStep(tm)(dt.Tensor(xs[0], device="cpu"))
    assert type(out) is torch.Tensor and len(dt.Graph.node_list) == 0


def _mode_switchers():
    """The port's own code that switches a model's mode for its own ends,
    each called once on a small CNN."""
    from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep
    from deepflows_tpu_torch.nn.fusion import fuse_conv_bn
    from deepflows_tpu_torch.utils.evaluate import evaluate_accuracy

    return {
        "fuse_conv_bn": lambda m, x, y: fuse_conv_bn(m, x),
        "CompiledEvalStep": lambda m, x, y: CompiledEvalStep(m)(x),
        "CompiledTrainStep": lambda m, x, y: CompiledTrainStep(
            m, toptim.SGD(m.parameters(), lr=0.1), tnn.CrossEntropyLoss()),
        "evaluate_accuracy": lambda m, x, y: evaluate_accuracy(m, [(x, y)], device="cpu"),
    }


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("caller", sorted(_mode_switchers()))
def test_internal_mode_switches_keep_the_tape_flag(caller, flag):
    """The port's internal ``train()`` / ``eval()`` calls leave the tape's
    flag as they found it, so a tape step afterwards still records and its
    gradients reach the parameters."""
    torch.manual_seed(0)
    model = tnn.Sequential(tnn.Conv2d(1, 2, 3, device="cpu"), tnn.BatchNorm2d(2, device="cpu"),
                           tnn.ReLU(), tnn.Flatten(), tnn.Linear(32, 3, device="cpu"))
    r = np.random.default_rng(3)
    x = r.standard_normal((4, 1, 6, 6)).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.int32)
    dt.set_grad_enabled(flag)
    _mode_switchers()[caller](model, x, y)
    assert dt.is_grad_enabled() is flag
    if flag:
        loss = tnn.CrossEntropyLoss()(model(dt.Tensor(x)), dt.Tensor(y))
        assert loss.requires_grad
        loss.backward()
        assert all(float(p.grad.abs().sum()) > 0 for p in model.parameters())


SCRIPT = """
    import sys

    import numpy as np

    from DeepFlows.tensor import *
    from DeepFlows import nn, optim
    import DeepFlows

    dev = sys.argv[1]
    DeepFlows.manual_seed(0)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    y = 3.0 * x + 5.0
    model = nn.Linear(1, 1, device=dev)
    criterion = nn.MSELoss()
    optimizer = optim.SGD(model.parameters(), lr=0.1)
    for epoch in range(200):
        loss = criterion(model(Tensor(x, device=dev)), Tensor(y, device=dev))
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        Graph.free_graph_all()
    print(DeepFlows.__name__, isinstance(loss, Tensor), type(loss).__module__.split(".")[0])
    print("fitted", float(model.weight.numpy().ravel()[0]), float(model.bias.numpy().ravel()[0]))
"""


@pytest.mark.parametrize("lazy", [None, "1"])
def test_shim_runs_a_reference_script(tmp_path, lazy):
    """The script with ``DEEPFLOWS_LAZY`` unset, and set to 1 (lazy mode
    from the port's import on)."""
    script = tmp_path / "linear_regression.py"
    script.write_text(textwrap.dedent(SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("DEEPFLOWS_LAZY", None)
    if lazy is not None:
        env["DEEPFLOWS_LAZY"] = lazy
    proc = subprocess.run([sys.executable, "-m", "deepflows_tpu_torch.shim", str(script), "cpu"],
                          capture_output=True, text=True, timeout=120, env=env,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.split("\n")
    assert lines[0] == "DeepFlows True deepflows_tpu_torch", proc.stdout
    w, b = (float(v) for v in lines[1].split()[1:])
    assert abs(w - 3.0) < 1e-2 and abs(b - 5.0) < 1e-2, proc.stdout
