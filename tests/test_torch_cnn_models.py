"""The CNN family of the port (deepflows_tpu_torch.models: MNIST_CNN,
CIFAR10_CNN, DishesCNN, ResNet18/34/50 with BatchNorm and norm-free,
MobileNetV1/V2, VGG16 with BatchNorm, ViT_Tiny) against the JAX package's
on the CPU, each built in both packages with its weights and buffers
copied across by ``load_jax_state_dict``.

- Every model's state dict has the JAX package's keys and shapes, and its
  eval output (``CompiledEvalStep``, running statistics set away from
  their init) agrees within rtol and atol 1e-4 (f32).  ResNet-50 and VGG16
  run at 32 × 32, B 1.
- ResNet-18 (small input, 16 × 16, B 4) trains 3 ``CompiledTrainStep``
  steps with ``SGD(lr=0.01, momentum=0.9)``, twice:
  - step by step: before each step the port is set to the JAX run's state
    (weights, running statistics and SGD's momentum through
    ``load_jax_optimizer_state``); the loss after it agrees within rtol
    1e-4, and each tensor of the weights, the running statistics and the
    momentum within 1e-4 of its norm;
  - running free, beside a float64 copy of the port: the losses of all 3
    steps within rtol 1e-4 of JAX's, and every tensor within 1e-4 after
    steps 1 and 2.  After step 3 some tensors part by more (a
    pre-activation within f32 rounding of 0 may take the other side of a
    ReLU, and BatchNorm over n = 16 values amplifies it); there the
    float64 run is the witness: the port's f32 state is no further from it,
    at its worst tensor, than the JAX package's.
- NF-ResNet-18 takes one ``SGD(lr=0.1)`` step, whose change to each weight
  is the gradient itself.  In f32, the loss within rtol 1e-4 and every
  tensor's change within 1e-4 of the JAX change's norm.  Under bf16
  compute, the loss within 2e-2 relative (tests/test_torch_train_step.py's
  bf16 bound) and each WSConv2d gain's change within 0.25 of JAX's by norm
  (bf16 rounding through the unnormalised blocks parts the two packages'
  gain gradients by up to 0.17 here; a gain that did not move would be 1
  away, one moved the wrong way 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledEvalStep as JaxEval
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu_torch import models as tmodels
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_optimizer_state, load_jax_state_dict

MODELS = {  # name: (constructor, keyword arguments, input shape)
    "mnist_cnn": ("MNIST_CNN", {}, (2, 1, 28, 28)),
    "cifar10_cnn": ("CIFAR10_CNN", {}, (2, 3, 32, 32)),
    "dishes_cnn": ("DishesCNN", dict(img_size=32), (2, 3, 32, 32)),
    "resnet18_small": ("ResNet18", dict(num_classes=10, small_input=True), (2, 3, 16, 16)),
    "resnet34": ("ResNet34", dict(num_classes=10), (1, 3, 32, 32)),
    "resnet50": ("ResNet50", dict(num_classes=10), (1, 3, 32, 32)),
    "nf_resnet50": ("ResNet50", dict(num_classes=10, norm="free"), (1, 3, 32, 32)),
    "mobilenet_v1": ("MobileNetV1", dict(num_classes=10, width_multiplier=0.5), (2, 3, 32, 32)),
    "mobilenet_v2": ("MobileNetV2", dict(num_classes=10, small_input=True), (2, 3, 16, 16)),
    "vgg16_bn": ("VGG16", dict(num_classes=10, batch_norm=True, img_size=32), (1, 3, 32, 32)),
    "vit_tiny": ("ViT_Tiny", dict(image_size=32, patch_size=8), (2, 3, 32, 32)),
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


def _jax_state(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _pair(name, seed=0, **extra):
    cls, kw, _ = MODELS[name]
    df.manual_seed(seed)
    jm = getattr(jmodels, cls)(device="cpu", **kw, **extra)  # numpy init; the steps move it
    tm = getattr(tmodels, cls)(device="cpu", **kw, **extra)
    return jm, tm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_state_dict_and_eval_match_jax(name):
    jm, tm = _pair(name)
    jsd = _jax_state(jm)
    rng = np.random.default_rng(sorted(MODELS).index(name))
    assert {k: v.shape for k, v in jsd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    for k in [k for k in jsd if k.endswith(("running_mean", "running_var"))]:
        shift = rng.standard_normal(jsd[k].shape).astype(np.float32) * 0.1
        jsd[k] = (jsd[k] + shift) if k.endswith("mean") else jsd[k] * np.exp(shift)
    jm.load_state_dict(jsd)
    load_jax_state_dict(tm, jsd)
    x = rng.standard_normal(MODELS[name][2]).astype(np.float32)
    want = np.asarray(JaxEval(jm)(x))
    got = CompiledEvalStep(tm)(x)
    assert tm.training  # the mode is restored
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _close_state(got, want, tol=1e-4):
    """Each tensor within ``tol`` of the JAX one by norm."""
    for k, v in want.items():
        v = np.asarray(v, np.float32)
        err = np.linalg.norm(got[k].float().numpy() - v) / max(np.linalg.norm(v), 1e-30)
        assert err <= tol, f"{k}: {err:.3g} of its norm"


def test_resnet18_sgd_steps_match_jax():
    jm, tm = _pair("resnet18_small", seed=1)
    jopt = joptim.SGD(jm.parameters(), lr=0.01, momentum=0.9)
    topt = optim.SGD(tm.parameters(), lr=0.01, momentum=0.9)
    jstep = JaxStep(jm, jopt, jnn.CrossEntropyLoss())
    tstep = CompiledTrainStep(tm, topt, tnn.CrossEntropyLoss())
    names = [n for n, _ in jm.named_parameters()]
    rng = np.random.default_rng(3)
    for i in range(3):
        load_jax_state_dict(tm, _jax_state(jm))
        jstate = jopt._state if jopt._state is not None else jopt.init_state()
        load_jax_optimizer_state(topt, {"v": [np.asarray(v) for v in jstate["v"]]})
        x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        lj, lt = float(jstep(x, y)), float(tstep(x, y))
        np.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=f"step {i}")
        _close_state(tm.state_dict(), _jax_state(jm))
        _close_state({n: v for n, v in zip(names, topt._state["v"])},
                     dict(zip(names, jopt._state["v"])))
    assert all(v.dtype == torch.float32 for k, v in tm.state_dict().items() if "running" in k)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_resnet18_free_sgd_trajectory_against_float64():
    jm, tm = _pair("resnet18_small", seed=1)
    t64 = tmodels.ResNet18(device="cpu", **MODELS["resnet18_small"][1])
    for m in (tm, t64):
        load_jax_state_dict(m, _jax_state(jm))
    t64.double()
    jstep = JaxStep(jm, joptim.SGD(jm.parameters(), lr=0.01, momentum=0.9),
                    jnn.CrossEntropyLoss())
    tstep, step64 = (CompiledTrainStep(m, optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
                                       tnn.CrossEntropyLoss()) for m in (tm, t64))
    rng = np.random.default_rng(3)
    for i in range(3):
        x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        lj, lt = float(jstep(x, y)), float(tstep(x, y))
        l64 = float(step64(torch.from_numpy(x).double(), y))
        np.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(lt, l64, rtol=1e-4, err_msg=f"step {i}")
        if i < 2:
            _close_state(tm.state_dict(), _jax_state(jm))
    jsd, tsd = _jax_state(jm), tm.state_dict()
    exact = {k: v.numpy() for k, v in t64.state_dict().items()}
    port = max(_rel(tsd[k].double().numpy(), exact[k]) for k in exact)
    ref = max(_rel(jsd[k].astype(np.float64), exact[k]) for k in exact)
    print(f"after step 3, worst tensor's distance from float64 by norm: port {port:.3g}, "
          f"JAX {ref:.3g}")
    assert port <= ref, f"the port's f32 state is {port:.3g} from float64, JAX's {ref:.3g}"


def _nf_step(seed, compute):
    """One NF-ResNet-18 SGD(lr 0.1) step in both packages from the same
    weights (WSConv2d gains set away from 1); returns the losses, the
    changes to every tensor (port, JAX) and the gains' names."""
    jm, tm = _pair("resnet18_small", seed=seed, norm="free")
    jsd = _jax_state(jm)
    rng = np.random.default_rng(4)
    gains = [k for k in jsd if k.endswith("gain")]
    assert gains and all(jsd[k].shape[1:] == (1, 1, 1) for k in gains)
    for k in gains:  # gains away from 1, carried by load_jax_state_dict
        jsd[k] = (1 + rng.standard_normal(jsd[k].shape) * 0.1).astype(np.float32)
    jm.load_state_dict(jsd)
    load_jax_state_dict(tm, jsd)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (None, None)
    jstep = JaxStep(jm, joptim.SGD(jm.parameters(), lr=0.1), jnn.CrossEntropyLoss(),
                    compute_dtype=jdt)
    tstep = CompiledTrainStep(tm, optim.SGD(tm.parameters(), lr=0.1), tnn.CrossEntropyLoss(),
                              compute_dtype=tdt)
    x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    lj, lt = float(jstep(x, y)), tstep(x, y)
    assert lt.dtype == torch.float32 and np.isfinite(float(lt))
    tsd, jsd2 = tm.state_dict(), _jax_state(jm)
    moved = {k: (tsd[k].numpy() - jsd[k], jsd2[k] - jsd[k]) for k in jsd}
    return float(lt), lj, moved, gains


def test_nf_resnet18_f32_step_matches_jax():
    lt, lj, moved, _ = _nf_step(2, "f32")
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    for k, (got, want) in moved.items():
        assert np.linalg.norm(want) > 0, k
        assert _rel(got, want) <= 1e-4, f"{k}: {_rel(got, want):.3g} of JAX's change"


def test_nf_resnet18_bf16_step_matches_jax():
    lt, lj, moved, gains = _nf_step(2, "bf16")
    np.testing.assert_allclose(lt, lj, rtol=2e-2)
    errs = {k: _rel(*moved[k]) for k in gains}
    print(f"bf16 gain changes, port against JAX, worst {max(errs.values()):.3g} of JAX's norm")
    for k, e in errs.items():
        assert e <= 0.25, f"{k}: {e:.3g} of JAX's change"
