"""Lazy mode (``deepflows_tpu_torch/backend/lazy.py``) on the CPU, and the
two faults of the tape it rests on.

- The faults: every optimizer of ``optim/`` steps two tape leaves as the
  JAX package's does; ``nn.Parameter.numpy()`` returns the values.
- Against the JAX package's lazy mode: a small CNN (conv 3->8, BN, ReLU,
  max-pool, flatten, dropout off, linear to 10, on 16 x 3 x 8 x 8) trained
  6 steps from JAX's weights in both packages, losses and weights within
  1e-4 as ``test_torch_cnn_models.py`` holds CNNs; a reference-style loop
  with ``dispose`` and ``Graph.free_graph_all``.
- Against the port's own eager loop, bit for bit: dropout on, a cosine
  schedule, 20 steps, BN's running statistics, enable after the model is
  built, one lazy step of every optimizer.
- The JAX lazy tests' contracts, counted (``tests/test_lazy.py``): the
  steady state, the per-op fallback, ``MAX_NODES``, the prefix fallback,
  alternating phases, mid-program enable, ``CompiledTrainStep`` in
  between, ``evaluate_accuracy``, checkpoints, bf16 purity, views and
  ``__setitem__``, concat and comparisons, ``disable()``.
- The port's own hazards: held losses, BN's scratch statistics.

Every test leaves both packages' lazy mode off (``_lazy_off`` fails one
that does not).
"""

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.backend import Device as JDevice
from deepflows_tpu.backend import lazy as jlazy
from deepflows_tpu_torch import lazy
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import optim as toptim
from deepflows_tpu_torch.utils import load_jax_state_dict

TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_tape_train.py's
CNN_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_cnn_models.py's
JDEV = JDevice("tpu")


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it."""
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
def _lazy_off(monkeypatch):
    """A Tensor made without ``device=`` on the CPU; both tapes empty and
    recording; and both packages' lazy mode off after the test, which fails
    if it left either on."""
    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    yield
    left = [name for name, mod in (("port", lazy), ("JAX", jlazy)) if mod.enabled()]
    lazy.disable()
    jlazy.disable()
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    if left:
        pytest.fail(f"the test left lazy mode on in {left}")


@pytest.fixture
def lazy_on():
    lazy.enable()
    try:
        yield
    finally:
        lazy.disable()


def _data(n=16, image=8, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, image, image).astype(np.float32),
            rng.randint(0, classes, (n,)))


def _cnn(p=0.5, conv_bias=True):
    return tnn.Sequential(
        tnn.Conv2d(3, 8, 3, padding=1, bias=conv_bias, device="cpu"),
        tnn.BatchNorm2d(8, device="cpu"),
        tnn.ReLU(),
        tnn.MaxPool2d(2),
        tnn.Flatten(),
        tnn.Dropout(p),
        tnn.Linear(8 * 4 * 4, 10, device="cpu"),
    )


def _jax_cnn(p=0.0):
    """The CNN of ``tests/test_lazy.py`` with dropout off and a bias-free
    conv: a bias before BN gets a gradient of rounding noise, which Adam
    scales up to a step, so its value is noise in either package."""
    return jnn.Sequential(
        jnn.Conv2d(3, 8, 3, padding=1, bias=False, device=JDEV),
        jnn.BatchNorm2d(8, device=JDEV),
        jnn.ReLU(),
        jnn.MaxPool2d(2),
        jnn.Flatten(),
        jnn.Dropout(p),
        jnn.Linear(8 * 4 * 4, 10, device=JDEV),
    )


def _stats_delta(before):
    after = lazy.lazy_stats()
    return {k: after[k] - before[k] for k in after}


def _train(steps=6, lazy_mode=False, enable_at=0, schedule=False, dropout=0.5, opt=None,
           held=False):
    """The JAX lazy tests' loop on the port: losses (each read as the step
    ends, or all at the end with ``held``), the final state dict and the
    counters' change."""
    dt.manual_seed(0)
    m = _cnn(dropout)
    crit = tnn.CrossEntropyLoss()
    o = toptim.Adam(m.parameters(), lr=1e-3) if opt is None else opt(m.parameters())
    sched = toptim.CosineAnnealingLR(o, T_max=4) if schedule else None
    X, Y = _data()
    m.train()
    before = lazy.lazy_stats()
    losses, kept = [], []
    try:
        for i in range(steps):
            if lazy_mode and i == enable_at:
                lazy.enable()
            loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
            o.zero_grad()
            loss.backward()
            o.step()
            if sched is not None:
                sched.step()
            if held:
                kept.append(loss)
            else:
                losses.append(float(loss.numpy()))
        losses += [float(k.numpy()) for k in kept]
        state = {k: v.detach().clone() for k, v in m.state_dict().items()}
    finally:
        lazy.disable()
    return losses, state, _stats_delta(before)


def _same(a, b):
    la, sa = a[:2]
    lb, sb = b[:2]
    assert la == lb
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ------------------------------------------------------------------ the two faults
OPTIMIZERS = {
    "sgd": ("SGD", dict(lr=0.1)),
    "sgd_momentum": ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-3)),
    "adam": ("Adam", dict(lr=1e-2)),
    "adamw": ("AdamW", dict(lr=1e-2, weight_decay=1e-2)),
    "rmsprop": ("RMSprop", dict(lr=1e-2, momentum=0.9, centered=True)),
    "adagrad": ("Adagrad", dict(lr=1e-2)),
    "adadelta": ("Adadelta", dict(lr=1.0)),
    "adafactor": ("Adafactor", dict(lr=0.02)),
    "lion": ("Lion", dict(lr=3e-3, weight_decay=0.1)),
    "muon": ("Muon", dict(lr=0.02, adamw_lr=3e-3)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_tape_leaves(name):
    """``optim.X([w, b])`` over two tape leaves, 3 steps, against the JAX
    package over the same leaves (the port raised: ``p.data`` is a
    BackendTensor)."""
    cls, kw = OPTIMIZERS[name]
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal((1, 3)).astype(np.float32)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    got = {}
    for pkg, optim, dev in ((df, joptim, JDevice("cpu")), (dt, toptim, "cpu")):
        w = pkg.Tensor(w0, device=dev, requires_grad=True)
        b = pkg.Tensor(b0, device=dev, requires_grad=True)
        opt = getattr(optim, cls)([w, b], **kw)
        for _ in range(3):
            loss = ((pkg.Tensor(x, device=dev) @ w + b) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        got[pkg] = (w.numpy(), b.numpy())
    for j, t in zip(got[df], got[dt]):
        np.testing.assert_allclose(t, np.asarray(j, np.float32), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_numpy(dtype):
    """``nn.Parameter.numpy()`` is a host copy as the JAX package's (bf16
    widened to f32); torch's refused a tensor that requires grad."""
    import jax.numpy as jnp

    a = np.random.default_rng(3).standard_normal((3, 4)).astype(np.float32)
    jp = jnn.Parameter(df.Tensor(a, dtype=getattr(jnp, dtype), device=JDEV))
    tp = tnn.Parameter(torch.from_numpy(a).to(getattr(torch, dtype)))
    got = tp.numpy()
    assert got.dtype == np.float32 and tp.requires_grad
    np.testing.assert_array_equal(got, np.asarray(jp.numpy(), np.float32))


# ------------------------------------------------------------------ against JAX
def test_cnn_matches_jax_lazy_mode():
    """Both packages' lazy modes train the CNN (dropout off) 6 steps from
    JAX's weights with Adam."""
    X, Y = _data()
    df.manual_seed(0)
    jm = _jax_cnn()
    tm = _cnn(0.0, conv_bias=False)
    load_jax_state_dict(tm, jm.state_dict())
    jopt = joptim.Adam(jm.parameters(), lr=1e-3)
    topt = toptim.Adam(tm.parameters(), lr=1e-3)
    jcrit, tcrit = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jm.train()
    tm.train()
    losses = {"jax": [], "port": []}
    for name, mod in (("jax", jlazy), ("port", lazy)):
        mod.enable()
        try:
            for _ in range(6):
                if name == "jax":
                    loss = jcrit(jm(df.Tensor(X, device=JDEV)), df.Tensor(Y, device=JDEV))
                    jopt.zero_grad()
                    loss.backward()
                    jopt.step()
                    losses[name].append(float(loss.data.numpy()))
                else:
                    loss = tcrit(tm(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
                    topt.zero_grad()
                    loss.backward()
                    topt.step()
                    losses[name].append(float(loss.numpy()))
        finally:
            mod.disable()
    np.testing.assert_allclose(losses["port"], losses["jax"], **CNN_TOL)
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jsd[k], np.float32), err_msg=k,
                                   **CNN_TOL)


def test_reference_loop_matches_jax():
    """A reference-style loop under lazy mode in both packages: per-batch
    tensors disposed, ``Graph.free_graph_all()`` each epoch, a readback a
    step."""
    X, Y = _data(n=32)
    df.manual_seed(0)
    jm = _jax_cnn()
    tm = _cnn(0.0, conv_bias=False)
    load_jax_state_dict(tm, jm.state_dict())
    got = {}
    for pkg, nn_, optim, mod, m, dev in ((df, jnn, joptim, jlazy, jm, JDEV),
                                        (dt, tnn, toptim, lazy, tm, "cpu")):
        crit, opt = nn_.CrossEntropyLoss(), optim.Adam(m.parameters(), lr=1e-3)
        m.train()
        losses = []
        mod.enable()
        try:
            for _ in range(2):
                for i in range(0, 32, 16):
                    x = pkg.Tensor(X[i:i + 16], device=dev)
                    y = pkg.Tensor(Y[i:i + 16], device=dev)
                    loss = crit(m(x), y)
                    opt.zero_grad()
                    loss.backward()
                    opt.step()
                    losses.append(float(np.asarray(loss.numpy())))
                    x.dispose()
                    y.dispose()
                pkg.Graph.free_graph_all()
        finally:
            mod.disable()
        got[pkg] = losses
    np.testing.assert_allclose(got[dt], got[df], **CNN_TOL)
    assert got[dt][-1] < got[dt][0] * 1.5


# ------------------------------------------------------------------ against eager
@pytest.mark.parametrize("case", ["dropout", "schedule", "long", "enable_after"])
def test_lazy_loop_is_bitwise_eager(case):
    """The lazy loop is the eager loop bit for bit: losses and the state
    dict (BN's running statistics too).  Dropout draws the same masks; a
    cosine schedule builds no new template (at most 2); 20 steps replay
    templates over most of the run; lazy mode enabled after the model and
    its first step."""
    kw = dict(steps=20 if case == "long" else 6, schedule=case == "schedule",
              enable_at=1 if case == "enable_after" else 0)
    eager = _train(lazy_mode=False, **kw)
    lz = _train(lazy_mode=True, **kw)
    _same(eager, lz)
    st = lz[2]
    assert st["eager_fallback_ops"] == 0 and st["eager_fallback_fragments"] == 0
    assert st["compiles"] <= 2
    assert st["fast_flushes"] >= kw["steps"] - 2 - kw["enable_at"]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS) + ["adam_fused"])
def test_optimizer_lazy_step_is_bitwise_eager(name):
    """Two steps of every optimizer on the CNN (the first makes its slots)
    are the eager steps bit for bit."""
    cls, kw = OPTIMIZERS.get(name, ("Adam", dict(lr=1e-3, fused=True)))

    def opt(params):
        return getattr(toptim, cls)(params, **kw)

    _same(_train(2, False, opt=opt), _train(2, True, opt=opt))


@pytest.mark.parametrize("name,dtype", [(n, d) for n in sorted(OPTIMIZERS)
                                         for d in (torch.float32, torch.bfloat16)]
                         + [("adam_fused", torch.float32)])
def test_graph_lr_computes_as_the_python_number(name, dtype):
    """A captured graph reads the optimizer's ``lr`` from the card as a
    ``_Number``: the update it makes is the update with the Python number,
    bit for bit, in f32 and bf16.  (A plain 0-d f32 tensor is not: it
    rounds ``lr`` to bf16 beside bf16 weights on the card, and computes
    Muon's ``lr * scale`` in f32.)"""
    from torch.utils._pytree import tree_flatten

    cls, kw = OPTIMIZERS.get(name, ("Adam", dict(lr=1e-3, fused=True)))
    got = []
    for form in ("python", "graph"):
        gen = torch.Generator().manual_seed(0)
        ps = [torch.nn.Parameter(torch.randn(shape, generator=gen).to(dtype))
              for shape in ((6, 5), (5,))]
        for p in ps:
            p.grad = torch.randn(p.shape, generator=gen).to(dtype)
        opt = getattr(toptim, cls)(ps, **kw)
        opt._ensure_state()
        leaves, spec = tree_flatten(opt._state)
        lr = 0.0123456789
        if form == "graph":
            lr = torch.tensor(lr, dtype=torch.float64).as_subclass(lazy._Number)
        with torch._C.DisableTorchFunction():  # as the graph's runner runs its nodes
            lazy._optimizer_node(opt, ps, leaves, spec, lr)
        got.append([p.detach().clone() for p in ps] +
                   [t.clone() for t in leaves if isinstance(t, torch.Tensor)])
    for a, b in zip(*got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_graph_reads_in_place_only_state_that_stays():
    """A graph reads an input where it lies only where the template's
    reference input (kept alive) lies: a parameter and a view of it; a
    batch, a slice of a dataset at another offset and a fresh tensor are
    copied into the graph's own tensors."""
    import types

    w, X = torch.zeros(4, 3), torch.arange(48.0).reshape(16, 3)
    tpl = types.SimpleNamespace(ref_leaves=[w, w, X[0:4], torch.ones(4, 3), X[0:4]])
    leaves = [w, w.data, X[4:8], torch.ones(4, 3), X[0:4]]
    assert lazy._direct(tpl, leaves) == [True, True, False, False, True]
    tpl.ref_leaves = None  # a template of the CPU keeps none
    assert lazy._direct(tpl, leaves[:2]) == [False, False]


def test_model_built_under_lazy_holds_its_values(lazy_on):
    """Parameters and buffers made under lazy mode hold their values (no
    placeholder), and the model is the one built eagerly from the seed."""
    dt.manual_seed(0)
    m = _cnn()
    assert not any(isinstance(t, lazy.LazyTensor) for t in [*m.parameters(), *m.buffers()])
    lazy.disable()
    dt.manual_seed(0)
    want = _cnn().state_dict()
    got = m.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_held_losses_keep_their_values():
    """Each step's loss Tensor, kept and read only after the last step,
    reads its own step's value."""
    _same(_train(6, False), _train(6, True, held=True))


def test_batch_norm_scratch_statistics_reach_running_stats(lazy_on):
    """``F.batch_norm`` makes its statistics with ``torch.zeros`` and has
    torch's batch norm write them; BatchNorm's running statistics read them
    in the same fragment: one lazy forward moves them as eager does."""
    X, _ = _data()
    dt.manual_seed(0)
    bn = tnn.BatchNorm2d(3, device="cpu")
    bn.train()
    bn(dt.Tensor(X, device="cpu"))
    lazy.disable()
    with torch.no_grad():
        x = torch.from_numpy(X)
        mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    rm, rv = bn.running_mean.reshape(-1), bn.running_var.reshape(-1)
    torch.testing.assert_close(rm, 0.1 * mean, **TOL)
    torch.testing.assert_close(rv, 0.9 + 0.1 * var, **TOL)


# ------------------------------------------------------------------ counted contracts
def test_steady_state_replays_one_template():
    """One flush a step; at most 2 templates (the first step makes Adam's
    slots); from the third step on every step matches a template."""
    lazy.enable()
    try:
        dt.manual_seed(0)
        m, crit = _cnn(), tnn.CrossEntropyLoss()
        opt = toptim.Adam(m.parameters(), lr=1e-3)
        X, Y = _data()
        m.train()
        before = lazy.lazy_stats()
        fast = []
        for _ in range(6):
            loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
            opt.zero_grad()
            loss.backward()
            opt.step()
            float(loss.numpy())
            fast.append(lazy.lazy_stats()["fast_flushes"])
        st = _stats_delta(before)
    finally:
        lazy.disable()
    assert st["flushes"] == 6
    assert st["compiles"] <= 2
    assert st["eager_fallback_fragments"] == 0
    assert [b - a for a, b in zip(fast[1:], fast[2:])] == [1, 1, 1, 1]
    assert lazy.lazy_stats()["fast_fallbacks"] - before["fast_fallbacks"] <= 1


def test_boolean_mask_falls_back_per_op(lazy_on):
    t = dt.Tensor(np.arange(12, dtype=np.float32).reshape(3, 4), device="cpu")
    before = lazy.lazy_stats()["eager_fallback_ops"]
    sub = t.data[np.array([True, False, True])]
    assert tuple(sub.shape) == (2, 4)
    assert lazy.lazy_stats()["eager_fallback_ops"] == before + 1
    np.testing.assert_allclose(sub.numpy(), np.arange(12, dtype=np.float32).reshape(3, 4)[[0, 2]])


def test_max_nodes_flushes(lazy_on, monkeypatch):
    monkeypatch.setattr(lazy, "MAX_NODES", 8)
    before = lazy.lazy_stats()["flushes"]
    t = dt.Tensor(np.ones((4, 4), np.float32), device="cpu")
    for _ in range(20):
        t = t * 1.5 + 0.1
    assert lazy.lazy_stats()["flushes"] > before  # flushed with no readback
    want = np.ones((4, 4), np.float32)
    for _ in range(20):
        want = want * np.float32(1.5) + np.float32(0.1)
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6)


def test_mismatch_clones_the_prefix(lazy_on):
    t = dt.Tensor(np.full((4, 4), 2.0, np.float32), device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(((t.data * 3.0) + 1.0).numpy(), np.full((4, 4), 7.0))
    before = lazy.lazy_stats()["fast_fallbacks"]
    np.testing.assert_array_equal(((t.data * 3.0) - 1.0).numpy(), np.full((4, 4), 5.0))
    assert lazy.lazy_stats()["fast_fallbacks"] == before + 1
    s0 = lazy.lazy_stats()["fast_flushes"]
    np.testing.assert_array_equal(((t.data * 3.0) - 1.0).numpy(), np.full((4, 4), 5.0))
    assert lazy.lazy_stats()["fast_flushes"] == s0 + 1


def test_alternating_phases_keep_their_templates(lazy_on):
    t = dt.Tensor(np.ones((4, 4), np.float32), device="cpu")

    def phase_a():
        return float(((t.data * 2.0) + 3.0).sum().numpy())

    def phase_b():
        return float(((t.data + 7.0) * 0.5).mean().numpy())

    for _ in range(2):
        assert phase_a() == 80.0 and phase_b() == 4.0
    before = lazy.lazy_stats()
    for _ in range(3):
        assert phase_a() == 80.0 and phase_b() == 4.0
    st = _stats_delta(before)
    assert st["compiles"] == 0 and st["fast_flushes"] == 6


def test_mid_program_enable_reaches_the_fast_path():
    """Enabled after the model holds its parameters: one flush a step, and
    the steps match templates."""
    dt.manual_seed(0)
    model = tnn.Sequential(tnn.Conv2d(3, 8, 3, padding=1, device="cpu"),
                           tnn.BatchNorm2d(8, device="cpu"), tnn.ReLU(), tnn.Flatten(),
                           tnn.Linear(8 * 8 * 8, 10, device="cpu"))
    opt, crit = toptim.Adam(model.parameters(), lr=1e-3), tnn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    before = lazy.lazy_stats()
    lazy.enable()
    try:
        for _ in range(6):
            loss = crit(model(dt.Tensor(x, device="cpu")), dt.Tensor(y, device="cpu"))
            opt.zero_grad()
            loss.backward()
            opt.step()
        lv = float(loss.numpy())
    finally:
        lazy.disable()
    st = _stats_delta(before)
    assert np.isfinite(lv)
    assert st["flushes"] <= 8 and st["fast_flushes"] >= 3


def test_compiled_step_in_between_records_nothing(lazy_on):
    from deepflows_tpu_torch.jit import CompiledTrainStep

    dt.manual_seed(3)
    m, crit = _cnn(), tnn.CrossEntropyLoss()
    opt = toptim.Adam(m.parameters(), lr=1e-3)
    X, Y = _data()
    m.train()
    loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
    opt.zero_grad()
    loss.backward()
    opt.step()
    step = CompiledTrainStep(m, opt, crit)
    nodes = lazy.lazy_stats()["nodes"]
    out = step(X, Y)
    assert lazy.lazy_stats()["nodes"] == nodes
    assert not isinstance(out, lazy.LazyTensor) and np.isfinite(float(out))
    loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
    assert lazy.lazy_stats()["nodes"] > nodes
    assert np.isfinite(float(loss.numpy()))


def test_evaluate_accuracy(lazy_on):
    from deepflows_tpu_torch.utils import evaluate_accuracy
    from deepflows_tpu_torch.utils.data import data_loader

    dt.manual_seed(0)
    m = _cnn()
    X, Y = _data(n=32)
    m.eval()
    acc = evaluate_accuracy(m, data_loader(X, Y, batch_size=8), device="cpu")
    assert 0.0 <= acc <= 1.0


def test_checkpoint_save_and_load(lazy_on, tmp_path):
    from deepflows_tpu_torch.utils import load_checkpoint, save_checkpoint

    dt.manual_seed(0)
    m, crit = _cnn(), tnn.CrossEntropyLoss()
    opt = toptim.Adam(m.parameters(), lr=1e-3)
    X, Y = _data()
    m.train()
    loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
    opt.zero_grad()
    loss.backward()
    opt.step()
    path = str(tmp_path / "lazy_ckpt.pkl")
    save_checkpoint(m, opt, epoch=1, loss=float(loss.numpy()), save_path=path)
    dt.manual_seed(1)
    m2 = _cnn()
    opt2 = toptim.Adam(m2.parameters(), lr=1e-3)
    load_checkpoint(m2, opt2, path)
    for (n1, p1), (n2, p2) in zip(m2.named_parameters(), m.named_parameters()):
        np.testing.assert_array_equal(p1.detach().numpy(), p2.detach().numpy(), err_msg=n1)


def test_bf16_scalar_purity(lazy_on):
    t = dt.Tensor(np.ones((4, 4), np.float32), device="cpu", dtype="bfloat16")
    out = t.data * 3.0 + 1.0
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.numpy(), np.full((4, 4), 4.0, np.float32))


def test_views_and_setitem(lazy_on):
    t = dt.Tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4), device="cpu")
    r = t.data.reshape((6, 4)).permute((1, 0)).broadcast_to((2, 4, 6))
    assert tuple(r.shape) == (2, 4, 6)
    ref = np.broadcast_to(np.arange(24, dtype=np.float32).reshape(6, 4).T, (2, 4, 6))
    np.testing.assert_array_equal(r.numpy(), ref)
    b = t.data
    b[0, 1] = 99.0
    assert b.numpy()[0, 1, 0] == 99.0 and t.numpy()[0, 1, 3] == 99.0


def test_concat_and_comparisons(lazy_on):
    a = dt.Tensor(np.ones((2, 3), np.float32), device="cpu")
    b = dt.Tensor(np.zeros((2, 3), np.float32), device="cpu")
    c = dt.concat([a, b], axis=0)
    assert tuple(c.shape) == (4, 3)
    np.testing.assert_array_equal((a.data == 1.0).numpy(), np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(c.numpy()[2:], np.zeros((2, 3), np.float32))


def test_disable_materializes_placeholders():
    """disable() runs what is pending and puts the values where
    placeholders were held: dicts, lists, tuples, closures, BackendTensors;
    eager ops work on them after."""
    lazy.enable()
    t = dt.Tensor(np.ones((3, 3), np.float32), device="cpu")
    u = t.data * 2.0
    raw = (t.data * 2.0).array
    assert isinstance(raw, lazy.LazyTensor)
    holder = {"state": (raw, 5)}
    lst = [((raw,), "tag")]

    def make(v):
        return lambda: v

    clo = make(raw)
    lazy.disable()
    assert not lazy.enabled()
    for got in (holder["state"][0], lst[0][0][0], clo(), u.array):
        assert not isinstance(got, lazy.LazyTensor)
        np.testing.assert_array_equal(got.numpy(), np.full((3, 3), 2.0))
    np.testing.assert_array_equal((u * 3.0).numpy(), np.full((3, 3), 6.0))


def test_disable_leaves_plain_parameters():
    """After lazy training and disable(), every parameter and optimizer slot
    is a plain tensor, and eager steps go on from them."""
    dt.manual_seed(0)
    m = tnn.Sequential(tnn.Linear(16, 32, device="cpu"), tnn.ReLU(),
                       tnn.Linear(32, 4, device="cpu"))
    opt, crit = toptim.Adam(m.parameters(), lr=1e-2), tnn.CrossEntropyLoss()
    rng = np.random.RandomState(0)
    X = rng.randn(32, 16).astype(np.float32)
    Y = rng.randint(0, 4, (32,))
    lazy.enable()
    try:
        for _ in range(3):
            loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
            opt.zero_grad()
            loss.backward()
            opt.step()
    finally:
        lazy.disable()
    assert np.isfinite(float(loss.numpy()))
    slots = [s for v in opt._state.values() for s in (v if isinstance(v, list) else [v])]
    assert not any(isinstance(p, lazy.LazyTensor) for p in list(m.parameters()) + slots)
    losses = []
    for _ in range(3):
        loss = crit(m(dt.Tensor(X, device="cpu")), dt.Tensor(Y, device="cpu"))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.numpy()))
    assert np.isfinite(losses).all()
