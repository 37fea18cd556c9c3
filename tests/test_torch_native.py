"""The port's ``cpu_native`` device (``deepflows_tpu_torch/backend/native_kernels.py``)
held against the JAX package's (``tests/test_native.py``'s cases).

Both packages build the same ``kernels.cpp`` with the same flags, so each
entry agrees bit for bit on the same inputs.  The MLP trains through the
C kernels on ``cpu_native`` (the port's call counter shows them), with
the ``cpu`` device's gradients and losses, and a failed build raises.

The JAX side runs on a private build of its own ``kernels.cpp``, made with
its Makefile's flags in this module's temporary directory (``_jax_native``):
the library the JAX package builds beside its source is linked in place by
``make``, and when several test workers import ``tests/test_native.py`` at
once on a tree without it, a worker can load it while another's linker
rewrites it; the JAX package then caches a disabled ``cpu_native`` device
for that whole process."""

import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu.backend import native_kernels as jnk
from deepflows_tpu.backend import numpy_kernels as npk
from deepflows_tpu_torch import Tensor, nn, optim
from deepflows_tpu_torch.backend import BackendDevice, Device
from deepflows_tpu_torch.backend import native_kernels as nk
from deepflows_tpu_torch.tensor import NativeTensor

RNG = np.random.default_rng(0)


def _makefile_flags(makefile):
    """The ``CXXFLAGS ?= ...`` default of the JAX package's Makefile."""
    m = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", makefile.read_text(), re.M)
    return tuple(m.group(1).split())


@pytest.fixture(scope="module", autouse=True)
def _jax_native(tmp_path_factory):
    """The JAX package's wrappers (``jnk``) and its ``cpu_native`` device
    over a private build of the JAX package's own ``kernels.cpp`` with its
    Makefile's flags (the port's ``CXX_FLAGS``), written to a temporary name
    and moved into place, for this module's tests; both are restored after.
    Nothing another process does to the shared library beside the JAX
    source reaches it, and a disabled device that the JAX package cached in
    this process is not used."""
    from deepflows_tpu.backend import device as jdevice

    here = Path(jnk._HERE)
    flags = _makefile_flags(here / "Makefile")
    assert flags == nk.CXX_FLAGS
    so = tmp_path_factory.mktemp("jax_native") / "libdeepflows_native.so"
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", str(tmp),
                           str(here / "kernels.cpp")], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        pytest.fail(f"the JAX package's kernels.cpp did not build:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnk, "_SO", str(so))
        mp.setattr(jnk, "_lib", None)
        if jnk._load() is None:
            pytest.fail(f"the JAX package's wrappers did not load {so}")
        mp.setattr(jdevice, "_cpu_native", jdevice.BackendDevice("cpu_native", jnk))
        yield


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DEEPFLOWS_BACKEND", "cpu")
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)
    yield
    for pkg in (df, dt):
        pkg.Graph.free_graph_all()
        pkg.set_grad_enabled(True)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_is_a_cpu_backend_device_bound_to_native_kernels():
    d = Device("cpu_native")
    assert isinstance(d, BackendDevice) and d.name == "cpu_native" and repr(d) == "cpu_native"
    assert d.kernels is nk and d.torch_device == torch.device("cpu")
    assert d is Device("CPU_Native") and d.enabled()
    assert nk.library_path().parent.parent == nk.BUILD  # its own build, in _build/
    assert nk.library_path().exists()
    _same(d.fill((4, 5), 3.25), np.full((4, 5), 3.25, np.float32))


def test_fill_roundtrip():
    _same(nk.fill((4, 5), 3.25), jnk.fill((4, 5), 3.25))


@pytest.mark.parametrize("entry", ["add", "sub", "mul", "div", "maximum", "eq", "ge"])
def test_ewise_entries_bitwise(entry):
    a = RNG.standard_normal((3, 7)).astype(np.float32)
    b = RNG.standard_normal((3, 7)).astype(np.float32) + 2
    b[0, :2] = a[0, :2]  # ties for eq / ge / maximum
    _same(getattr(nk, f"ewise_{entry}")(torch.from_numpy(a), b),
          getattr(jnk, f"ewise_{entry}")(a, b))


@pytest.mark.parametrize("entry", ["add", "mul", "div", "power", "maximum", "eq", "ge"])
def test_scalar_entries_bitwise(entry):
    a = np.abs(RNG.standard_normal((3, 7)).astype(np.float32))
    a[0, 0] = 1.5
    _same(getattr(nk, f"scalar_{entry}")(a, 1.5), getattr(jnk, f"scalar_{entry}")(a, 1.5))


def test_unary_entries_bitwise():
    a = RNG.standard_normal((3, 7)).astype(np.float32)
    for entry in ("exp", "tanh"):
        _same(getattr(nk, f"ewise_{entry}")(a), getattr(jnk, f"ewise_{entry}")(a))
    p = np.abs(a) + 0.1
    _same(nk.ewise_log(p), jnk.ewise_log(p))


def test_log_neg_inf_contract():
    """-inf for non-positive inputs, as the reference's CUDA kernel
    (``ndarray_backend_cuda.cu:403-414``)."""
    out = nk.ewise_log(np.array([1.0, 0.0, -2.0], np.float32))
    assert out[0] == pytest.approx(0.0)
    assert out[1] == -np.inf and out[2] == -np.inf


@pytest.mark.parametrize("m,n,p", [(3, 4, 5), (64, 64, 64), (100, 37, 251), (512, 64, 96)])
def test_matmul_bitwise(m, n, p):
    """Row counts above the thread-chunk threshold (512) take the threaded
    SGEMM; each row is one thread's sum, so the result is bitwise too."""
    a = RNG.standard_normal((m, n)).astype(np.float32)
    b = RNG.standard_normal((n, p)).astype(np.float32)
    got = nk.matmul(a, b)
    _same(got, jnk.matmul(a, b))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-4)


def test_reductions():
    a = RNG.standard_normal((4, 5, 6)).astype(np.float32)
    _same(nk.reduce_sum(a, axis=2), jnk.reduce_sum(a, axis=2))
    _same(nk.reduce_sum(a, axis=(1, 2), keepdims=True), jnk.reduce_sum(a, (1, 2), True))
    _same(nk.reduce_max(a, axis=2), jnk.reduce_max(a, axis=2))
    # a leading axis is not the kernel's: both fall back (torch / NumPy)
    np.testing.assert_allclose(nk.reduce_sum(a, axis=0).numpy(), a.sum(axis=0), rtol=1e-6)
    calls = nk.calls["reduce_sum"]
    nk.reduce_sum(a, axis=0)
    assert nk.calls["reduce_sum"] == calls


def test_conv2d_bitwise():
    x = RNG.standard_normal((2, 3, 11, 9)).astype(np.float32)
    w = RNG.standard_normal((4, 3, 3, 3)).astype(np.float32)
    for s, p in [(1, 0), (1, 1), (2, 1), (2, 2)]:
        got = nk.conv2d(x, w, s, p)
        _same(got, jnk.conv2d(x, w, s, p))
        np.testing.assert_allclose(got.numpy(), npk.conv2d(x, w, s, p), rtol=1e-4, atol=1e-5)


def test_maxpool_bitwise():
    x = RNG.standard_normal((2, 3, 9, 9)).astype(np.float32)
    for k, s, p in [(2, 2, 0), (3, 2, 1), (3, 1, 0)]:
        _same(nk.max_pool2d(x, k, s, p), jnk.max_pool2d(x, k, s, p))


def test_batchnorm_bitwise():
    x = RNG.standard_normal((4, 5, 6, 7)).astype(np.float32) * 3 + 1
    g = RNG.standard_normal((1, 5, 1, 1)).astype(np.float32)
    b = RNG.standard_normal((1, 5, 1, 1)).astype(np.float32)
    for gamma, beta in [(g, b), (None, None)]:
        for got, want in zip(nk.batchnorm_train(x, gamma, beta, (0, 2, 3), 1e-5),
                             jnk.batchnorm_train(x, gamma, beta, (0, 2, 3), 1e-5)):
            _same(got, want)


X = RNG.standard_normal((64, 8)).astype(np.float32)
YL = (X @ RNG.standard_normal((8, 2)).astype(np.float32)).argmax(1).astype(np.int32)


def _mlp_run(device, init, steps=30):
    model = nn.Sequential(nn.Linear(8, 16, device=device), nn.ReLU(),
                          nn.Linear(16, 2, device=device))
    with torch.no_grad():
        for p, q in zip(model.parameters(), init):
            p.copy_(q)
    opt = optim.Adam(model.parameters(), lr=0.05)
    crit = nn.CrossEntropyLoss()
    losses, grads = [], []
    for _ in range(steps):
        x = Tensor(X, device=device)
        out = model(x)
        loss = crit(out, Tensor(YL, device=device))
        opt.zero_grad()
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        opt.step()
        losses.append(float(loss.numpy()))
    return losses, grads, (x, out, loss)


def test_train_on_native_device():
    """tests/test_native.py's MLP: on cpu_native it trains through the C
    kernels (counted), every step's gradients within 1e-5 of the cpu
    device's, the loss halved; the cpu device runs none of them."""
    torch.manual_seed(0)
    ref = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(), nn.Linear(16, 2, device="cpu"))
    init = [p.detach().clone() for p in ref.parameters()]
    nk.calls.clear()
    want, wgrads, _ = _mlp_run("cpu", init)
    assert sum(nk.calls.values()) == 0
    got, grads, (x, out, loss) = _mlp_run("cpu_native", init)
    assert all(type(t) is NativeTensor for t in (x, out, loss))
    # a step: 2 products forward, 3 backward; bias adds, ReLU, the CE's ops
    assert nk.calls["matmul"] == 30 * 5
    for entry in ("ewise_add", "scalar_maximum", "reduce_max", "ewise_exp", "reduce_sum",
                  "ewise_log"):
        assert nk.calls[entry] >= 30, entry
    for gs, ws in zip(grads, wgrads):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0] * 0.5


def test_native_matches_jax_native_training_step():
    """One raw-tape step on both packages' cpu_native: values and the
    gradient within 1e-6 (the same C SGEMM underneath)."""
    w0 = RNG.standard_normal((8, 2)).astype(np.float32)
    outs = []
    for pkg in (df, dt):
        w = pkg.Tensor(w0, device="cpu_native", requires_grad=True)
        y = pkg.tensor.sum(pkg.tensor.exp(pkg.Tensor(X, device="cpu_native") @ w))
        y.backward()
        outs.append((np.asarray(y.numpy()), np.asarray(w.grad.numpy())))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-6)


def test_to_native_and_back():
    t = Tensor(X, device="cpu")
    n = t.to("cpu_native")
    assert type(n) is NativeTensor and type(n.to("cpu")) is dt.Tensor
    assert n.to("cpu_native") is n


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nk, "SOURCE", bad)
    monkeypatch.setattr(nk, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed for kernels.cpp"):
        nk.build()
    assert not nk.library_path().exists()
