"""The port's device layer (deepflows_tpu_torch/backend/) against the JAX
package's: ``BackendTensor`` on the CPU beside the JAX package's on its
``cpu`` device (the cases of tests/test_ndarray.py), the kernel module
``torch_kernels`` (the cases of tests/test_tpu_backend.py), the device
registry, ``DEEPFLOWS_BACKEND``, the card raising without one, and
``cpu_native`` as a CPU device over the C++ kernel library.

Values agree within 1e-6 relative (exactly where both compute the same
f32 operation).
"""

import numpy as np
import pytest
import torch

from deepflows_tpu import backend as jbackend
from deepflows_tpu_torch import backend as backend_api
from deepflows_tpu_torch.backend import BackendDevice, BackendTensor, Device
from deepflows_tpu_torch.backend import device as devmod
from deepflows_tpu_torch.backend import torch_kernels as K

TOL = dict(rtol=1e-6, atol=1e-6)
CARD = torch.cuda.is_available()


def bt(a):
    return BackendTensor(np.asarray(a, dtype=np.float32), device=Device("cpu"))


def jbt(a):
    return jbackend.BackendTensor(np.asarray(a, dtype=np.float32), device=jbackend.Device("cpu"))


def test_roundtrip():
    a = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    t = bt(a)
    np.testing.assert_array_equal(t.numpy(), a)
    assert t.shape == (3, 4) and t.size == 12 and t.ndim == 2
    assert t.dtype == torch.float32 and t.strides == (4, 1)
    assert t.item is not None and len(t) == 3
    np.testing.assert_array_equal(np.asarray(t), a)


def test_fill_and_full():
    t = backend_api.full((2, 3), 7.5, device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.full((2, 3), 7.5, np.float32))
    assert float(backend_api.zeros_like(t).numpy().sum()) == 0.0
    assert float(backend_api.ones_like(t).numpy().sum()) == 6.0
    assert backend_api.empty((2, 2), device="cpu").shape == (2, 2)
    t.fill(1.0)
    np.testing.assert_array_equal(t.numpy(), np.ones((2, 3), np.float32))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow", "rsub", "rdiv", "rpow",
                                "maximum", "minimum", "neg"])
def test_elementwise_matches_jax(op):
    rng = np.random.default_rng(1)
    a = np.abs(rng.standard_normal((4, 5))).astype(np.float32) + 0.5
    b = rng.standard_normal((4, 5)).astype(np.float32) + 2.0
    f = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y,
         "div": lambda x, y: x / y, "pow": lambda x, y: x**2.0, "rsub": lambda x, y: 1.0 - x,
         "rdiv": lambda x, y: 2.0 / x, "rpow": lambda x, y: 2.0**x,
         "maximum": lambda x, y: x.maximum(y), "minimum": lambda x, y: x.minimum(1.0),
         "neg": lambda x, y: -x}[op]
    np.testing.assert_allclose(f(bt(a), bt(b)).numpy(), np.asarray(f(jbt(a), jbt(b)).numpy()),
                               **TOL)


def test_scalar_ops_and_broadcast():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = bt(a)
    np.testing.assert_array_equal((t + 1.0).numpy(), a + 1.0)
    np.testing.assert_array_equal((2.0 * t).numpy(), 2.0 * a)
    np.testing.assert_array_equal((t + bt(np.ones((1, 4)))).numpy(), a + 1.0)


def test_views():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t = bt(a)
    np.testing.assert_array_equal(t.reshape((6, 4)).numpy(), a.reshape(6, 4))
    np.testing.assert_array_equal(t.permute((2, 0, 1)).numpy(), a.transpose(2, 0, 1))
    np.testing.assert_array_equal(t.transpose((1, 0, 2)).numpy(), a.transpose(1, 0, 2))
    np.testing.assert_array_equal(t.T.numpy(), a.transpose(2, 1, 0))
    np.testing.assert_array_equal(t.broadcast_to((5, 2, 3, 4)).numpy(),
                                  np.broadcast_to(a, (5, 2, 3, 4)))
    np.testing.assert_array_equal(t.flip(1).numpy(), np.flip(a, 1))
    np.testing.assert_array_equal(t.flip().numpy(), np.flip(a))
    np.testing.assert_array_equal(t.pad(((0, 0), (1, 1), (2, 0))).numpy(),
                                  np.pad(a, ((0, 0), (1, 1), (2, 0))))
    np.testing.assert_array_equal(backend_api.expand_dims(t, 0).numpy(), a[None])
    assert t.compact() is t and t.is_compact()
    assert not t.permute((2, 0, 1)).is_compact()


def test_getitem_setitem():
    a = np.arange(20, dtype=np.float32).reshape(4, 5)
    t = bt(a)
    np.testing.assert_array_equal(t[1:3, ::2].numpy(), a[1:3, ::2])
    np.testing.assert_array_equal(t[bt([0, 2]).astype(torch.int64)].numpy(), a[[0, 2]])
    t[0, :] = 9.0
    a2 = a.copy()
    a2[0, :] = 9.0
    np.testing.assert_array_equal(t.numpy(), a2)
    t[1:3, 1:3] = bt(np.zeros((2, 2)))
    a2[1:3, 1:3] = 0
    np.testing.assert_array_equal(t.numpy(), a2)


def test_frozen_refuses_writes():
    """The JAX package's mutability check."""
    t = bt(np.ones((2, 2)))
    t._frozen = True
    for write in (lambda: t.fill(0.0), lambda: t.__setitem__(0, 1.0),
                  lambda: t.__iadd__(1.0), lambda: t.__imul__(2.0)):
        with pytest.raises(RuntimeError, match="frozen"):
            write()
    np.testing.assert_array_equal(t.numpy(), np.ones((2, 2)))


def test_matmul(monkeypatch):
    """``@`` against JAX's, and the kernel route taken only under
    ``use_pallas`` for 2-D f32 pairs."""
    from deepflows_tpu_torch import config
    from deepflows_tpu_torch.ops import linear

    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((3, 4)), rng.standard_normal((4, 5))
    a3 = rng.standard_normal((2, 3, 4))
    np.testing.assert_allclose((bt(a) @ bt(b)).numpy(), np.asarray((jbt(a) @ jbt(b)).numpy()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((bt(a3) @ bt(b)).numpy(), np.asarray((jbt(a3) @ jbt(b)).numpy()),
                               rtol=1e-5, atol=1e-6)
    calls = []
    monkeypatch.setattr(linear, "matmul", lambda x, y: calls.append(1) or x @ y)
    saved = config.use_pallas
    try:
        config.use_pallas = False
        bt(a) @ bt(b)
        assert calls == []
        config.use_pallas = True
        bt(a) @ bt(b)
        bt(a3) @ bt(b)  # 3-D: torch.matmul
        BackendTensor(a, device="cpu", dtype=torch.float64) @ BackendTensor(
            b, device="cpu", dtype=torch.float64)
        assert calls == [1]
    finally:
        config.use_pallas = saved


def test_reductions():
    a = np.random.default_rng(3).standard_normal((3, 4, 5)).astype(np.float32)
    t, j = bt(a), jbt(a)
    for f in (lambda x: x.sum(), lambda x: x.sum(axis=(0, 2)), lambda x: x.sum(1, True),
              lambda x: x.max(axis=1, keepdims=True), lambda x: x.max(), lambda x: x.min(0),
              lambda x: x.mean(axis=1), lambda x: x.mean(), lambda x: x.mean((0, 1), True),
              lambda x: backend_api.summation(x, 2), lambda x: backend_api.max(x, 0)):
        np.testing.assert_allclose(f(t).numpy(), np.asarray(f(j).numpy()), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t.argmax(1).numpy(), a.argmax(1))
    np.testing.assert_array_equal(t.argmin(2).numpy(), a.argmin(2))


def test_unary_math():
    a = np.abs(np.random.default_rng(4).standard_normal((3, 3))).astype(np.float32) + 0.1
    t, j = bt(a), jbt(a)
    for name in ("log", "exp", "tanh", "sqrt", "abs", "sign"):
        np.testing.assert_allclose(getattr(t, name)().numpy(),
                                   np.asarray(getattr(j, name)().numpy()), rtol=1e-6)


@pytest.mark.parametrize("op", ["eq", "ne", "ge", "le", "gt", "lt"])
def test_comparisons_produce_float(op):
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got = getattr(bt(a), f"__{op}__")(2.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jbt(a), f"__{op}__")(2.0).numpy()))
    assert got.dtype == np.float32


def test_to_and_astype():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = bt(a)
    assert t.to("cpu") is t and t.to(torch.device("cpu")) is t
    h = t.astype("bfloat16")
    assert h.dtype == torch.bfloat16 and h.numpy().dtype == np.float32
    np.testing.assert_array_equal(h.numpy(), a)  # small integers are exact in bf16
    np.testing.assert_array_equal(t.astype(np.int32).numpy(), a.astype(np.int32))


def test_scatter_add():
    vals = torch.ones((2, 3))
    out = K.scatter_add((4, 3), (np.array([1, 1]),), vals, device=torch.device("cpu"))
    want = np.zeros((4, 3), np.float32)
    np.add.at(want, (np.array([1, 1]),), 1.0)
    np.testing.assert_array_equal(out.numpy(), want)
    out = Device("cpu").scatter_add((2, 5), (slice(None), slice(1, 3)), torch.ones((2, 2)))
    assert out.numpy().sum() == 4.0 and out.numpy()[:, 1:3].min() == 1.0


def test_kernel_module_roundtrips():
    """tests/test_tpu_backend.py's cases on ``torch_kernels``."""
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(K.to_numpy(K.fill((4, 5), 3.25)),
                                  np.full((4, 5), 3.25, np.float32))
    a = rng.standard_normal((3, 7)).astype(np.float32)
    np.testing.assert_array_equal(K.to_numpy(K.from_numpy(a)), a)
    b = rng.standard_normal((7, 8)).astype(np.float32)
    np.testing.assert_allclose(K.to_numpy(K.matmul(K.from_numpy(a), K.from_numpy(b))), a @ b,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(K.to_numpy(K.reduce_sum(K.from_numpy(a), axis=1)), a.sum(1),
                               rtol=1e-5)
    np.testing.assert_array_equal(K.to_numpy(K.reduce_max(K.from_numpy(a), axis=0)), a.max(0))
    z = K.from_numpy(np.zeros((4, 4), np.float32))
    out = K.setitem(z, (slice(1, 3), slice(None)), 7.0)
    assert K.to_numpy(out)[1:3].min() == 7.0 and K.to_numpy(z).max() == 0.0
    assert K.from_numpy(np.arange(3)).dtype == torch.int32  # the JAX dtype rule
    assert K.from_numpy(np.ones(3)).dtype == torch.float32


def test_dropout_mask_and_rng_use_package_generators():
    """Draws come from the package generator of the device (reseeded by
    ``manual_seed``), never from torch's global generator."""
    import deepflows_tpu_torch as dt

    cpu = Device("cpu")
    state = torch.get_rng_state()
    dt.manual_seed(3)
    m = K.to_numpy(cpu.dropout_mask((4000,), 0.8))
    kept = m > 0
    assert 0.75 < kept.mean() < 0.85
    np.testing.assert_allclose(m[kept], 1.25, rtol=1e-6)
    r1 = cpu.randn(5).numpy()
    dt.manual_seed(3)
    cpu.dropout_mask((4000,), 0.8)
    np.testing.assert_array_equal(cpu.randn(5).numpy(), r1)
    cpu.manual_seed(9)
    u = K.to_numpy(cpu.uniform(-2, 2, (100,)))
    assert u.min() >= -2 and u.max() <= 2
    ri = K.to_numpy(cpu.randint(0, 5, (100,)))
    assert ri.min() >= 0 and ri.max() < 5
    np.testing.assert_array_equal(cpu.one_hot([1, 0], 3).numpy(), [[0, 1, 0], [1, 0, 0]])
    assert torch.equal(torch.get_rng_state(), state)


def test_registry():
    cpu = Device("cpu")
    assert cpu is devmod.cpu() is Device(torch.device("cpu")) is Device(cpu)
    assert cpu.name == "cpu" and repr(cpu) == "cpu" and cpu.enabled()
    assert cpu == torch.device("cpu") and cpu.torch_device == torch.device("cpu")
    assert devmod.all_devices()[0] is cpu
    assert len(devmod.all_devices()) == 1 + torch.cuda.device_count()
    assert hash(cpu) == hash(Device("cpu"))
    for bad in ("tpuv4", "", 3):
        with pytest.raises(ValueError):
            Device(bad)


def test_default_device_env_override(monkeypatch):
    """The default is the card, the CPU only when ``DEEPFLOWS_BACKEND``
    asks for it; an unknown name raises (the JAX package warns and keeps
    its CPU default)."""
    for name in ("cpu", "np", " CPU "):
        monkeypatch.setenv("DEEPFLOWS_BACKEND", name)
        assert devmod.default_device().name == "cpu"
        assert Device(None) is devmod.cpu()
    monkeypatch.setenv("DEEPFLOWS_BACKEND", "bogus")
    with pytest.raises(ValueError, match="DEEPFLOWS_BACKEND='bogus'"):
        devmod.default_device()
    for name in (None, "", "nd", "tpu", "cuda"):
        if name is None:
            monkeypatch.delenv("DEEPFLOWS_BACKEND", raising=False)
        else:
            monkeypatch.setenv("DEEPFLOWS_BACKEND", name)
        if CARD:
            assert devmod.default_device().name == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                devmod.default_device()


def test_default_device_env_reaches_tensor(monkeypatch):
    import deepflows_tpu_torch as dt

    from deepflows_tpu_torch import device as entry

    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")
    assert dt.Tensor(np.ones((2, 2), np.float32)).device == torch.device("cpu")
    assert entry.Device(None) == torch.device("cpu")  # one registry: the entry points agree
    for name in ("cuda", None):
        if name is None:
            monkeypatch.delenv("DEEPFLOWS_BACKEND", raising=False)
        else:
            monkeypatch.setenv("DEEPFLOWS_BACKEND", name)
        if CARD:
            assert dt.Tensor(np.ones((2, 2), np.float32)).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                dt.Tensor(np.ones((2, 2), np.float32))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry.Device(None)


@pytest.mark.skipif(CARD, reason="checks the refusal without a card")
@pytest.mark.parametrize("name", ["cuda", "gpu", "tpu", "cuda:0"])
def test_card_names_raise_without_a_card(name):
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import device as entry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Device(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.Tensor(np.ones(2), device=name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.Device(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.default_accelerator()


def test_cpu_native_is_not_ported():
    """The name predates the port of ``cpu_native``: ``Device('cpu_native')``
    is now a CPU ``BackendDevice`` bound to ``native_kernels``, one
    singleton, distinct from ``cpu`` (tests/test_torch_native.py holds its
    kernels against the JAX package's)."""
    from deepflows_tpu_torch.backend import native_kernels

    d = Device("cpu_native")
    assert isinstance(d, BackendDevice) and d is devmod.cpu_native()
    assert d.name == "cpu_native" and d.torch_device == torch.device("cpu")
    assert d.kernels is native_kernels and d.fill is not None
    assert d != devmod.cpu() and devmod.cpu().kernels is not native_kernels


def test_entry_points_take_either_kind_of_device():
    """The port's ``device=`` arguments take a ``BackendDevice`` as well as
    a name or a ``torch.device``."""
    from deepflows_tpu_torch import device as entry
    from deepflows_tpu_torch import models
    from deepflows_tpu_torch.random import generator

    assert entry.Device(Device("cpu")) == torch.device("cpu")
    m = models.MLP(in_features=4, hidden=(3,), num_classes=2, device=Device("cpu"))
    assert next(m.parameters()).device == torch.device("cpu")
    assert generator(Device("cpu")) is generator(torch.device("cpu"))
