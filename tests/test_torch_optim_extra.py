"""The port's optimizers beyond Adam and SGD (AdamW, Muon, Adafactor, Lion,
RMSprop, Adagrad, Adadelta), its schedulers, gradient clipping and
ModelEMA against the JAX package on the CPU.

- Each optimizer's ``pure_update`` over the same 5 steps of seeded numpy
  gradients, one of them None, on f32 parameters of 1 to 4 dims and one
  bf16 parameter: every parameter and state slot after every step.
  Tolerance: f32 rtol 1e-5 / atol 1e-6 (Muon's Newton-Schulz matmuls
  rtol 1e-4 / atol 1e-5); the bf16 parameter and its slots within one
  bf16 rounding of the element and of the tensor's largest (rtol 2^-7,
  atol 2^-7 · max: the JAX package's bf16 products may run with XLA's
  excess precision).
- Each scheduler's lr sequence over 12 steps exactly equal to JAX's, and
  after a state-dict round trip.
- ``clip_by_global_norm`` and ``clip_grad_norm_`` (rtol 1e-6); ModelEMA's
  shadow weights over 5 updates with and without warm-up (rtol 1e-6),
  ``average_parameters`` swapping them in and the live weights back bit
  for bit, ``copy_to``, and the JAX state dict loaded as it is.
- A resume: two JAX ``CompiledTrainStep`` steps with Muon, Adafactor and
  AdamW, weights and optimizer state across (Muon's None ``v`` entries,
  Adafactor's factored slots), two more steps on each side (losses and
  weights rtol 1e-4 / atol 1e-5).
- In the port alone, as the JAX suite checks its own: the eager
  ``step()`` against ``CompiledTrainStep`` (rtol 2e-4 / atol 2e-5, the
  JAX test's) and a resume from ``state_dict`` (rtol 1e-6); Newton-Schulz
  against JAX's (rtol 1e-4) with singular values in [0.45, 1.35].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_optimizer_state, load_jax_state_dict

RNG = np.random.default_rng(29)
SHAPES = ((4, 3), (5,), (2, 3, 3, 3), (6, 4))
BF16 = 3  # the index of the bf16 parameter
OPTIMIZERS = {
    "adamw": ("AdamW", dict(lr=1e-2, weight_decay=1e-2)),
    "adamw_no_decay": ("AdamW", dict(lr=1e-2, weight_decay=0.0)),
    "muon": ("Muon", dict(lr=0.02, adamw_lr=3e-3)),
    "muon_plain_decay": ("Muon", dict(lr=0.02, nesterov=False, weight_decay=0.01)),
    "adafactor": ("Adafactor", dict(lr=0.02)),
    "adafactor_decay": ("Adafactor", dict(lr=0.05, weight_decay=0.01, d=0.5)),
    "lion": ("Lion", dict(lr=3e-3, weight_decay=0.1)),
    "rmsprop": ("RMSprop", dict(lr=1e-2)),
    "rmsprop_centered_momentum": ("RMSprop", dict(lr=1e-2, momentum=0.9, centered=True,
                                                  weight_decay=1e-3)),
    "adagrad": ("Adagrad", dict(lr=1e-2, weight_decay=1e-3)),
    "adadelta": ("Adadelta", dict(lr=1.0, weight_decay=1e-3)),
}


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
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _bf16_torch(a):
    """A JAX bf16 array's bits as a torch bf16 tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16_tol(want):
    """One bf16 rounding of the element and of the tensor's largest: the
    bf16 parameter's gradient products are bf16 in both packages, and XLA
    may compute a chain of them with excess precision."""
    return dict(rtol=2**-7, atol=2**-7 * float(np.abs(_np(want)).max()))


def _state_close(tstate, jstate, tol):
    assert set(tstate) == set(jstate)
    for key, jv in jstate.items():
        tv = tstate[key]
        if isinstance(jv, list):
            for i, (a, b) in enumerate(zip(tv, jv)):
                assert (a is None) == (b is None), key
                if b is not None:
                    t = _bf16_tol(b) if i == BF16 else tol
                    np.testing.assert_allclose(_np(a), _np(b), err_msg=f"{key}[{i}]", **t)
        else:
            assert int(tv) == int(np.asarray(jv)), key


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_pure_update_matches_jax(name):
    cls, kw = OPTIMIZERS[name]
    params = [RNG.standard_normal(s).astype(np.float32) for s in SHAPES]
    jopt = getattr(joptim, cls)([Tensor(p, device="tpu") for p in params], **kw)
    topt = getattr(optim, cls)([torch.nn.Parameter(torch.from_numpy(p.copy()))
                                for p in params], **kw)
    jstate, tstate = jopt.init_state(), topt.init_state()
    jp = [jnp.asarray(p) for p in params]
    jp[BF16] = jp[BF16].astype(jnp.bfloat16)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tp[BF16] = _bf16_torch(jp[BF16])
    tol = dict(rtol=1e-4, atol=1e-5) if cls == "Muon" else dict(rtol=1e-5, atol=1e-6)
    # one program per None pattern, as the JAX optimizers' eager step runs it
    update = jax.jit(lambda p, g, st: jopt.pure_update(p, g, st, kw["lr"]))
    for step in range(5):
        grads = [RNG.standard_normal(s).astype(np.float32) for s in SHAPES]
        jg = [jnp.asarray(g) for g in grads]
        jg[BF16] = jg[BF16].astype(jnp.bfloat16)
        tg = [torch.from_numpy(g) for g in grads]
        tg[BF16] = _bf16_torch(jg[BF16])
        if step == 2:  # a parameter without a gradient
            jg[1] = tg[1] = None
        jp, jstate = update(jp, jg, jstate)
        tp, tstate = topt.pure_update(tp, tg, tstate, kw["lr"])
        for i, (a, b) in enumerate(zip(tp, jp)):
            assert a.dtype == (torch.bfloat16 if i == BF16 else torch.float32)
            t = _bf16_tol(b) if i == BF16 else tol
            np.testing.assert_allclose(_np(a), _np(b), err_msg=f"step {step} param {i}", **t)
        _state_close(tstate, jstate, tol)


def test_state_layouts_hold_none_where_jax_does():
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in ((4, 4), (4,), (2, 3, 5))]
    muon = optim.Muon(ps).init_state()
    assert [v is None for v in muon["v"]] == [True, False, True]
    af = optim.Adafactor(ps).init_state()
    assert [tuple(r.shape) if r is not None else None for r in af["row"]] == [
        (4, 1), None, (2, 3, 1)]
    assert [tuple(c.shape) if c is not None else None for c in af["col"]] == [
        (1, 4), None, (2, 1, 5)]
    assert [v is None for v in af["var"]] == [True, False, True]
    assert set(optim.RMSprop(ps, momentum=0.9).init_state()) == {"square_avg", "momentum_buf"}
    assert set(optim.Lion(ps).init_state()) == {"m"}


class _FakeOpt:
    def __init__(self, lr):
        self.lr = lr


SCHEDULERS = {
    "step": ("StepLR", dict(step_size=3, gamma=0.5)),
    "cosine": ("CosineAnnealingLR", dict(T_max=5, eta_min=0.01)),
    "linear": ("LinearLR", dict(start_factor=0.25, end_factor=1.0, total_iters=4)),
    "one_cycle": ("OneCycleLR", dict(max_lr=1.0, total_steps=10, pct_start=0.3)),
    "warmup_cosine": ("WarmupCosineLR", dict(warmup_epochs=2, T_max=6)),
    "warmup_cosine_start": ("WarmupCosineLR", dict(warmup_epochs=3, T_max=5, base_lr=0.2,
                                                   warmup_start_lr=0.01, eta_min=0.001)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_lr_sequence_equals_jax(name):
    cls, kw = SCHEDULERS[name]
    jo, to = _FakeOpt(0.3), _FakeOpt(0.3)
    js, ts = getattr(joptim, cls)(jo, **kw), getattr(optim, cls)(to, **kw)
    want, got = [jo.lr], [to.lr]
    for _ in range(12):
        js.step()
        ts.step()
        want.append(jo.lr)
        got.append(to.lr)
    assert got == want
    sd = ts.state_dict()
    assert sd == js.state_dict() and "optimizer" not in sd
    again = getattr(optim, cls)(_FakeOpt(0.3), **kw)
    again.load_state_dict(sd)
    again.optimizer.lr = to.lr
    js.step()
    again.step()
    assert again.optimizer.lr == jo.lr


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipping_matches_jax(max_norm):
    from deepflows_tpu.optim.clip import clip_by_global_norm as jclip

    grads = [RNG.standard_normal(s).astype(np.float32) for s in SHAPES[:3]]
    grads[1] = None
    want = jclip(max_norm)([None if g is None else jnp.asarray(g) for g in grads])
    got = optim.clip_by_global_norm(max_norm)(
        [None if g is None else torch.from_numpy(g) for g in grads])
    assert got[1] is None and want[1] is None
    for a, b in zip(got, want):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # the eager clip on .grad: the same norm, the same gradients
    jps = [jnn.Parameter(Tensor(np.zeros(s, np.float32), device="tpu")) for s in SHAPES[:3]]
    tps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES[:3]]
    for jp, tp, g in zip(jps, tps, grads):
        if g is not None:
            jp.grad = df.BackendTensor(g, device=jp.device)
            tp.grad = torch.from_numpy(g.copy())
    jnorm = joptim.clip_grad_norm_(jps, max_norm)
    tnorm = optim.clip_grad_norm_(tps, max_norm)
    assert isinstance(tnorm, float)
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-6)
    for jp, tp in zip(jps, tps):
        if jp.grad is not None:
            np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad.array), rtol=1e-6)
    assert optim.clip_grad_norm_([torch.nn.Parameter(torch.zeros(2))], 1.0) == 0.0


def _mlp_pair(seed):
    """Linear → LayerNorm → Tanh → Linear in both packages, the JAX
    weights copied: LayerNorm's gain and bias are the 1-D parameters that
    Muon gives AdamW and Adafactor a full variance."""
    df.manual_seed(seed)
    jm = jnn.Sequential(jnn.Linear(6, 8, device="tpu"), jnn.LayerNorm(8, device="tpu"),
                        jnn.Tanh(), jnn.Linear(8, 3, device="tpu"))
    tm = tnn.Sequential(tnn.Linear(6, 8, device="cpu"), tnn.LayerNorm(8, device="cpu"),
                        tnn.Tanh(), tnn.Linear(8, 3, device="cpu"))
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("warmup", [True, False])
def test_model_ema_matches_jax(warmup):
    jm, tm = _mlp_pair(3)
    jema = joptim.ModelEMA(jm, decay=0.9, warmup=warmup)
    tema = optim.ModelEMA(tm, decay=0.9, warmup=warmup)
    for _ in range(5):
        new = {k: (np.asarray(v) + RNG.standard_normal(v.shape) * 0.1).astype(np.float32)
               for k, v in jm.state_dict().items()}
        jm.load_state_dict(new)
        load_jax_state_dict(tm, new)
        jema.update()
        tema.update()
    jsd, tsd = jema.state_dict(), tema.state_dict()
    assert tsd["num_updates"] == jsd["num_updates"] == 5
    for k, v in jsd["shadow"].items():
        np.testing.assert_allclose(tsd["shadow"][k].numpy(), v, rtol=1e-6, atol=1e-7, err_msg=k)
    live = {n: (p.data_ptr(), p.detach().clone()) for n, p in tm.named_parameters()}
    with tema.average_parameters():
        for n, p in tm.named_parameters():
            assert torch.equal(p, tsd["shadow"][n])
    for n, p in tm.named_parameters():  # the live tensors back, bit for bit
        assert p.data_ptr() == live[n][0] and torch.equal(p, live[n][1])
    again = optim.ModelEMA(tm, decay=0.5)
    again.load_state_dict(jsd)  # the JAX state dict as it is
    assert again.decay == 0.9 and again.num_updates == 5
    again.copy_to()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jsd["shadow"][n], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        optim.ModelEMA(tm, decay=1.0)


RESUME = {
    "muon": ("Muon", dict(lr=0.02, adamw_lr=3e-3)),
    "adafactor": ("Adafactor", dict(lr=0.02)),
    "adamw": ("AdamW", dict(lr=1e-2, weight_decay=1e-2)),
}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resume_from_jax(name):
    """Two JAX steps, then weights and optimizer state across to the port;
    two more steps on each side agree."""
    cls, kw = RESUME[name]
    jm, tm = _mlp_pair(5)
    jstep = JaxStep(jm, getattr(joptim, cls)(jm.parameters(), **kw), jnn.CrossEntropyLoss())
    batches = [(RNG.standard_normal((8, 6)).astype(np.float32),
                RNG.integers(0, 3, 8).astype(np.int32)) for _ in range(4)]
    for x, y in batches[:2]:
        jstep(x, y)
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    topt = getattr(optim, cls)(tm.parameters(), **kw)
    jstate = jstep.optimizer.state_dict()["state"]
    load_jax_optimizer_state(topt, {
        k: [None if a is None else np.asarray(a) for a in v] if isinstance(v, list)
        else np.asarray(v) for k, v in jstate.items()})
    if cls == "Muon":
        assert [v is None for v in topt._state["v"]] == [True, True, False, False, True, True]
    if cls == "Adafactor":
        assert tuple(topt._state["row"][0].shape) == (6, 1)
        assert topt._state["row"][2] is None and topt._state["var"][0] is None
    assert int(topt._state["t"]) == 2
    tstep = CompiledTrainStep(tm, topt, tnn.CrossEntropyLoss())
    for x, y in batches[2:]:
        np.testing.assert_allclose(float(tstep(x, y)), float(jstep(x, y)), rtol=1e-4)
    tsd = tm.state_dict()
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_load_state_refuses_a_none_or_a_shape_that_differs():
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in ((4, 4), (4,))]
    good = {"m": [np.zeros((4, 4)), np.zeros(4)], "v": [None, np.zeros(4)], "t": 3}
    load_jax_optimizer_state(optim.Muon(ps), good)
    with pytest.raises(ValueError, match="None"):
        load_jax_optimizer_state(optim.Muon(ps), dict(good, v=[np.zeros((4, 4)), np.zeros(4)]))
    with pytest.raises(ValueError, match="None"):
        load_jax_optimizer_state(optim.Muon(ps), dict(good, v=[None, None]))
    with pytest.raises(ValueError, match="shape"):
        load_jax_optimizer_state(optim.Adafactor(ps), {
            "row": [np.zeros((1, 4)), None], "col": [np.zeros((1, 4)), None],
            "var": [None, np.zeros(4)], "t": 1})


@pytest.mark.parametrize("name", ["adamw", "muon", "adafactor", "lion", "rmsprop_centered_momentum",
                                  "adagrad", "adadelta"])
def test_eager_step_equals_the_train_step_and_resumes_from_its_state_dict(name):
    """Optimizer.step() on .grad (forward, backward, step) and
    CompiledTrainStep take the same trajectory, as in the JAX suite; a
    state_dict loaded into a fresh optimizer resumes it exactly."""
    cls, kw = OPTIMIZERS[name]
    x = RNG.standard_normal((16, 6)).astype(np.float32)
    y = RNG.integers(0, 3, 16).astype(np.int32)
    models = []
    for _ in range(3):
        dt.manual_seed(7)
        models.append(tnn.Sequential(tnn.Linear(6, 8, device="cpu"), tnn.LayerNorm(8, device="cpu"),
                                     tnn.Tanh(), tnn.Linear(8, 3, device="cpu")))
    eager, compiled, resumed = models
    opt = getattr(optim, cls)(eager.parameters(), **kw)
    crit = tnn.CrossEntropyLoss()
    step = CompiledTrainStep(compiled, getattr(optim, cls)(compiled.parameters(), **kw), crit)
    for i in range(4):
        loss = crit(eager(torch.from_numpy(x)), torch.from_numpy(y))
        opt.zero_grad()
        loss.backward()
        opt.step()
        step(x, y)
        if i == 1:
            resumed.load_state_dict(eager.state_dict())
            ropt = getattr(optim, cls)(resumed.parameters(), **kw)
            ropt.load_state_dict(opt.state_dict())
            rstep = CompiledTrainStep(resumed, ropt, crit)
        elif i > 1:
            rstep(x, y)
    for a, b, c in zip(eager.parameters(), compiled.parameters(), resumed.parameters()):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(c, b, rtol=1e-6, atol=1e-7)


def test_newton_schulz_matches_jax_and_orthogonalises():
    from deepflows_tpu.optim.muon import ns_orthogonalize as jns
    from deepflows_tpu_torch.optim.muon import ns_orthogonalize

    for shape in [(16, 32), (32, 16), (24, 24)]:
        g = RNG.standard_normal(shape).astype(np.float32)
        o = ns_orthogonalize(torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(o, np.asarray(jns(jnp.asarray(g))), rtol=1e-4, atol=1e-5)
        s = np.linalg.svd(o, compute_uv=False)
        assert s.max() < 1.35 and s.min() > 0.45, (shape, s.min(), s.max())
