"""The port's checkpoints (``utils.save_checkpoint``, ``load_checkpoint``,
``AsyncCheckpointer``) against the JAX package's on the CPU, and the utils
that came with them (``evaluate``, ``model_configs``, ``_build_model``).

A file written by either package loads in the other with every array
equal: parameters, BatchNorm's running statistics and Adam's ``v`` / ``s``
/ ``t`` (bf16 weights too); a reference-layout file with only ``v`` /
``s`` / ``t`` loads; strict loading raises on a name, a shape or a slot
count the model does not have.  ``AsyncCheckpointer.save`` gives the state
of the moment it was called although fused Adam updates the parameters in
place afterwards (the write is held back until those updates ran), bounds
the saves in flight and leaves no partial file.
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu import utils as jutils
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu_torch import models, nn, ops, optim, utils
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_state_dict, model_utils

RNG = np.random.default_rng(31)
X = RNG.standard_normal((8, 6)).astype(np.float32)
Y = RNG.integers(0, 3, 8)


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


def _net(pkg, device="cpu"):
    """Linear, BatchNorm1d (running statistics as buffers), ReLU, Linear."""
    return pkg.Sequential(pkg.Linear(6, 8, device=device), pkg.BatchNorm1d(8, device=device),
                          pkg.ReLU(), pkg.Linear(8, 3, device=device))


def _jax_trained(steps=2):
    df.manual_seed(2)
    jm = _net(jnn, device="tpu")
    jstep = JaxStep(jm, joptim.Adam(jm.parameters(), lr=0.01), jnn.CrossEntropyLoss())
    for _ in range(steps):
        jstep(X, Y)
    return jm, jstep


def _port_trained(steps=2, fused=True):
    tm = _net(nn)
    tstep = CompiledTrainStep(tm, optim.Adam(tm.parameters(), lr=0.01, fused=fused),
                              nn.CrossEntropyLoss())
    for _ in range(steps):
        tstep(X, Y)
    return tm, tstep


def _walk(obj):
    """Every leaf of a checkpoint dict."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _walk(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _walk(v)
    else:
        yield obj


def test_jax_file_loads_in_the_port(tmp_path):
    """JAX's checkpoint of a trained BN model with Adam: every parameter,
    running statistic and slot comes back equal, t and lr too, and the
    next step's loss matches JAX's within 1e-5."""
    path = str(tmp_path / "jax.pkl")
    jm, jstep = _jax_trained()
    jutils.save_checkpoint(jm, jstep.optimizer, epoch=2, loss=0.25, save_path=path)
    tm = _net(nn)
    topt = optim.Adam(tm.parameters(), lr=0.5, fused=True)
    info = utils.load_checkpoint(tm, topt, path)
    assert info == {"epoch": 2, "loss": 0.25} and topt.lr == 0.01
    for n, arr in jm.state_dict().items():
        np.testing.assert_array_equal(tm.state_dict()[n].numpy(), arr, err_msg=n)
    jstate = jstep.optimizer.state_dict()["state"]
    for k in ("v", "s"):
        for a, b in zip(topt._state[k], jstate[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(topt._state["t"]) == int(np.asarray(jstate["t"])) == 2
    tstep = CompiledTrainStep(tm, topt, nn.CrossEntropyLoss())
    want, got = float(jstep(X, Y)), float(tstep(X, Y))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def test_port_file_loads_in_jax(tmp_path):
    """The port's checkpoint holds numpy arrays and Python scalars only, in
    the JAX layout (t from 1; v and s the lists of full_state), and JAX's
    load_checkpoint restores every array equal."""
    path = str(tmp_path / "port.pkl")
    tm, tstep = _port_trained()
    utils.save_checkpoint(tm, tstep.optimizer, epoch=3, loss=0.5, save_path=path)
    with open(path, "rb") as f:
        ck = pickle.load(f)
    assert set(ck) == {"epoch", "loss", "model_parameters", "model_buffers", "optimizer_state"}
    assert all(isinstance(v, (np.ndarray, int, float, str, type(None))) for v in _walk(ck))
    assert list(ck["model_buffers"]) == ["1.running_mean", "1.running_var"]
    st = ck["optimizer_state"]
    assert st["type"] == "Adam" and st["t"] == 3 and st["v"] is st["full_state"]["v"]
    df.manual_seed(9)
    jm = _net(jnn, device="tpu")
    jopt = joptim.Adam(jm.parameters(), lr=0.5)
    assert jutils.load_checkpoint(jm, jopt, path) == {"epoch": 3, "loss": 0.5}
    assert jopt.lr == 0.01
    for n, arr in jm.state_dict().items():
        np.testing.assert_array_equal(arr, tm.state_dict()[n].numpy(), err_msg=n)
    for k in ("v", "s"):
        for a, b in zip(jopt._state[k], tstep.optimizer._state[k]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(jopt._state["t"])) == 2


def test_bf16_weights_cross_both_ways(tmp_path):
    """bf16 parameters: the port writes them as f32 (exact) and JAX reads
    them back into its bf16 model bit for bit; JAX's bf16 arrays are read
    by the port by their bits."""
    df.manual_seed(4)
    jm = _net(jnn).bfloat16()
    tm = _net(nn).bfloat16()
    load_jax_state_dict(tm, jm.state_dict())
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.125)  # a change JAX must see
    tpath, jpath = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    utils.save_checkpoint(tm, save_path=tpath)
    with open(tpath, "rb") as f:
        assert all(a.dtype == np.float32 for a in pickle.load(f)["model_parameters"].values())
    jutils.load_checkpoint(jm, None, tpath)
    jutils.save_checkpoint(jm, save_path=jpath)
    back = _net(nn).bfloat16()
    utils.load_checkpoint(back, None, jpath)
    for (n, a), b in zip(tm.named_parameters(), back.parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n


def test_reference_layout_file(tmp_path):
    """A file with Adam's v / s / t only (the reference's layout, t from
    1): both packages install the same slots and step count."""
    tm = _net(nn)
    shapes = [tuple(p.shape) for p in tm.parameters()]
    v = [RNG.standard_normal(s).astype(np.float32) for s in shapes]
    s_ = [RNG.random(s).astype(np.float32) for s in shapes]
    path = str(tmp_path / "ref.pkl")
    with open(path, "wb") as f:
        pickle.dump({"epoch": 7, "loss": 1.5,
                     "model_parameters": {n: p.detach().numpy() for n, p in tm.named_parameters()},
                     "optimizer_state": {"type": "Adam", "lr": 0.002, "v": v, "s": s_, "t": 5}},
                    f)
    topt = optim.Adam(tm.parameters())
    assert utils.load_checkpoint(tm, topt, path)["epoch"] == 7
    assert int(topt._state["t"]) == 4 and topt.lr == 0.002
    df.manual_seed(1)
    jm = _net(jnn)
    jopt = joptim.Adam(jm.parameters())
    jutils.load_checkpoint(jm, jopt, path)
    assert int(np.asarray(jopt._state["t"])) == 4
    for k, want in (("v", v), ("s", s_)):
        for a, b, w in zip(topt._state[k], jopt._state[k], want):
            np.testing.assert_array_equal(a.numpy(), w)
            np.testing.assert_array_equal(np.asarray(b), w)


def _edit(ck, case):
    mp = ck["model_parameters"]
    if case == "unknown_parameter":
        mp["extra.weight"] = np.zeros(3, np.float32)
    elif case == "unknown_buffer":
        ck["model_buffers"]["extra.running_mean"] = np.zeros(3, np.float32)
    elif case == "shape":
        mp["0.weight"] = np.zeros((5, 8), np.float32)
    elif case == "slot_count":
        ck["optimizer_state"]["full_state"]["v"].pop()
    elif case == "slot_shape":
        ck["optimizer_state"]["full_state"]["s"][0] = np.zeros((2, 2), np.float32)


STRICT = {  # case: (error when strict, error when not)
    "unknown_parameter": (KeyError, None),
    "unknown_buffer": (KeyError, None),
    "shape": (ValueError, ValueError),
    "slot_count": (ValueError, ValueError),
    "slot_shape": (ValueError, ValueError),
}


@pytest.mark.parametrize("case", list(STRICT))
def test_strict_errors(tmp_path, case):
    tm, tstep = _port_trained(steps=1)
    path = str(tmp_path / "ck.pkl")
    utils.save_checkpoint(tm, tstep.optimizer, save_path=path)
    with open(path, "rb") as f:
        ck = pickle.load(f)
    _edit(ck, case)
    with open(path, "wb") as f:
        pickle.dump(ck, f)
    for strict, err in zip((True, False), STRICT[case]):
        fresh = _net(nn)
        opt = optim.Adam(fresh.parameters())
        if err is None:
            utils.load_checkpoint(fresh, opt, path, strict=strict)
            torch.testing.assert_close(fresh.state_dict(), tm.state_dict(), rtol=0, atol=0)
        else:
            with pytest.raises(err):
                utils.load_checkpoint(fresh, opt, path, strict=strict)


class _HeldWrites:
    """Holds AsyncCheckpointer's background writes until ``release()``, so
    a test decides what runs before a write reads its snapshot."""

    def __init__(self, monkeypatch):
        self.gate = threading.Event()
        write = model_utils._write_checkpoint

        def held(*args):
            assert self.gate.wait(60)
            return write(*args)

        monkeypatch.setattr(model_utils, "_write_checkpoint", held)

    def release(self):
        self.gate.set()


def test_async_save_is_the_state_at_the_call(tmp_path, monkeypatch):
    """save() then three fused-Adam steps (in place) before the write may
    run: the file equals a synchronous save taken at the call, and it
    loads and resumes like one."""
    tm, tstep = _port_trained(steps=1)
    spath, apath = str(tmp_path / "sync.pkl"), str(tmp_path / "async.pkl")
    before = [p.data_ptr() for p in tm.parameters()]
    utils.save_checkpoint(tm, tstep.optimizer, epoch=1, save_path=spath)
    held = _HeldWrites(monkeypatch)
    with utils.AsyncCheckpointer() as ck:
        fut = ck.save(tm, tstep.optimizer, epoch=1, save_path=apath)
        for _ in range(3):
            tstep(X, Y)
        assert [p.data_ptr() for p in tm.parameters()] == before  # updated in place
        held.release()
        assert fut.result(timeout=60) == apath
    with open(spath, "rb") as f:
        s = pickle.load(f)
    with open(apath, "rb") as f:
        a = pickle.load(f)
    for part in ("model_parameters", "model_buffers"):
        for n, arr in s[part].items():
            np.testing.assert_array_equal(a[part][n], arr, err_msg=n)
            assert not np.array_equal(tm.state_dict()[n].numpy(), arr), n  # the steps moved it
    for k in ("v", "s"):
        for x, y in zip(a["optimizer_state"][k], s["optimizer_state"][k]):
            np.testing.assert_array_equal(x, y)
    assert a["optimizer_state"]["t"] == s["optimizer_state"]["t"] == 2
    tm2 = _net(nn)
    opt2 = optim.Adam(tm2.parameters(), fused=True)
    utils.load_checkpoint(tm2, opt2, apath)
    assert int(opt2._state["t"]) == 1


def test_async_backpressure_atomicity_and_errors(tmp_path, monkeypatch):
    """With max_pending 2 a third save waits for the first write; every
    file is whole and no temporary file is left; a write's error is raised
    by wait()."""
    held = _HeldWrites(monkeypatch)
    tm, tstep = _port_trained(steps=1)
    ck = utils.AsyncCheckpointer(max_pending=2)
    paths = [str(tmp_path / f"c{i}.pkl") for i in range(4)]
    ck.save(tm, tstep.optimizer, epoch=0, save_path=paths[0])
    ck.save(tm, tstep.optimizer, epoch=1, save_path=paths[1])
    third = threading.Thread(target=lambda: ck.save(tm, None, epoch=2, save_path=paths[2]))
    third.start()
    third.join(0.3)
    assert third.is_alive()  # held back by the two in flight
    held.release()
    third.join(60)
    assert not third.is_alive()
    ck.save(tm, None, epoch=3, save_path=paths[3])
    ck.close()
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            assert pickle.load(f)["epoch"] == i
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with utils.AsyncCheckpointer() as bad:
        bad.save(tm, save_path=str(blocker / "ck.pkl"))
        with pytest.raises(OSError):
            bad.wait()
    with pytest.raises(ValueError):
        utils.AsyncCheckpointer(max_pending=0)


# ---------------------------------------------------------------- the utils
def test_evaluate_matches_jax():
    logits = RNG.standard_normal((20, 7)).astype(np.float32)
    y = RNG.integers(0, 7, 20)
    onehot = np.eye(7, dtype=np.float32)[y]
    np.testing.assert_allclose(utils.softmax(logits), jutils.softmax(logits), rtol=1e-6)
    for yy in (y, onehot):
        assert utils.accuracy(torch.as_tensor(logits), yy) == jutils.accuracy(logits, yy)
        for k in (1, 3, 7):
            assert utils.topk_accuracy(logits, yy, k) == jutils.topk_accuracy(logits, yy, k)
    acc = utils.Accumulator(2)
    acc.add(3, 4.0)
    acc.add(1, 1)
    assert acc[0] == 4.0 and acc[1] == 5.0
    acc.reset()
    assert acc[0] == 0.0
    tm, _ = _port_trained(steps=1)
    batches = [(X[:4], Y[:4]), (X[4:], Y[4:])]
    with torch.no_grad():
        tm.eval()
        want = utils.accuracy(tm(torch.as_tensor(X)), Y) / len(Y)
        tm.train()
    assert utils.evaluate_accuracy(tm, batches) == want and tm.training


def test_model_configs_and_build_model_match_jax():
    from deepflows_tpu.utils import model_configs as jcfg
    from deepflows_tpu.utils.pretrained_models import _build_model as jbuild
    from deepflows_tpu_torch.utils.pretrained_models import _build_model

    for name in ("MODEL_METADATA", "RESNET_BLOCK_CONFIG", "VGG_CONFIG", "MOBILENET_V1_CONFIG",
                 "IMAGENET_STATS"):
        assert getattr(utils, name) == getattr(jcfg, name)
    for name in ("resnet18", "vgg16", "nope"):
        assert utils.get_model_config(name) == jcfg.get_model_config(name)
        assert utils.is_model_supported(name) == jcfg.is_model_supported(name)
    assert utils.get_normalization_stats() == jcfg.get_normalization_stats()
    for name in ("resnet18", "mobilenet_v2"):
        tm = _build_model(name, num_classes=10, device="cpu")
        assert isinstance(tm, nn.Module)
        assert sorted(tm.state_dict()) == sorted(jbuild(name, num_classes=10, device="cpu")
                                                 .state_dict())
    assert isinstance(_build_model("resnet50", 4, device="cpu"), models.ResNet)
    with pytest.raises(ValueError, match="unsupported"):
        _build_model("alexnet", device="cpu")
