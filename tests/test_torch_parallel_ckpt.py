"""Checkpoints of the port's sharded runs (``utils.model_utils`` on
DTensor parameters and optimizer slots), on 4 gloo ranks
(``tests/torch_parallel_ranks.py``, case ``ckpt``):

- an FSDP run of the Conv/BN/Linear model with Adam saves after 2 of 4
  steps (every rank gathers, rank 0 writes; ``save_checkpoint`` and
  ``AsyncCheckpointer`` write the same arrays), a fresh model and
  optimizer load the file and a new ``ShardedTrainStep`` resumes: the
  last 2 losses and the weights are the uninterrupted run's (the JAX
  test's bound, rtol 1e-5 / atol 1e-6);
- the same file resumes on a mesh of 2 ranks (``{data: 2}`` over ranks 0
  and 1) with half-size blocks, to the same bound;
- the JAX package's ``load_checkpoint`` reads the file and its FSDP step
  on 4 devices resumes to the port's losses (rtol 1e-4 / atol 1e-5).
"""

import pickle

import numpy as np
import pytest

import deepflows_tpu as df
from deepflows_tpu import Graph, nn, optim

import torch_parallel_ranks as ranks

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


@pytest.fixture(autouse=True)
def _clean():
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)


def jax_cnn():
    df.manual_seed(0)
    return nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1, bias=False, device="cpu"),
        nn.BatchNorm2d(8, device="cpu"), nn.ReLU(), nn.MaxPool2d(2), nn.Flatten(),
        nn.Linear(8 * 8 * 8, 32, device="cpu"), nn.ReLU(), nn.Linear(32, 4, device="cpu"))


def batch(i=0, n=16):
    r = np.random.default_rng(i)
    return (r.standard_normal((n, 3, 16, 16)).astype(np.float32),
            r.integers(0, 4, n).astype(np.int32))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    state = {k: np.asarray(v) for k, v in jax_cnn().state_dict().items()}
    inp = {"ckpt": dict(state=state, batches=[batch(i) for i in range(4)],
                        path=str(d / "sharded.pkl"), async_path=str(d / "async.pkl"))}
    w = ranks.World(["ckpt"], inp, d)
    return w.case("ckpt"), inp["ckpt"]


def close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def test_fsdp_checkpoint_resume(ckpt):
    got, _ = ckpt
    for r in got:
        close(r["losses_c"], r["losses_a"][2:], 1e-5, 1e-6)
        for n in r["params_a"]:
            close(r["params_c"][n], r["params_a"][n], 1e-5, 1e-6, n)


def test_elastic_resume_on_two_ranks(ckpt):
    got, _ = ckpt
    for r in got[:2]:
        close(r["losses_r"], r["losses_a"][2:], 1e-5, 1e-6)
        for n in r["params_a"]:
            close(r["params_r"][n], r["params_a"][n], 1e-5, 1e-6, n)
        local, total = r["sizes_r"]["5.weight"]  # (512, 32): dim 0 in halves
        assert local * 2 == total
    assert all("losses_r" not in r for r in got[2:])


def test_async_checkpoint_writes_the_same_arrays(ckpt):
    _, inp = ckpt
    with open(inp["path"], "rb") as f:
        a = pickle.load(f)
    with open(inp["async_path"], "rb") as f:
        b = pickle.load(f)
    for key in ("model_parameters", "model_buffers"):
        assert list(a[key]) == list(b[key])
        for n in a[key]:
            np.testing.assert_array_equal(a[key][n], b[key][n])
    for x, y in zip(a["optimizer_state"]["v"], b["optimizer_state"]["v"]):
        np.testing.assert_array_equal(x, y)


def test_jax_package_resumes_from_a_sharded_port_file(ckpt):
    from deepflows_tpu.parallel import ShardedTrainStep, fsdp_rules, make_mesh
    from deepflows_tpu.utils.model_utils import load_checkpoint

    got, inp = ckpt
    m = jax_cnn()
    opt = optim.Adam(m.parameters(), lr=1e-3)
    load_checkpoint(m, opt, inp["path"])
    mesh = make_mesh({"data": 4}, jax.devices()[:4])
    step = ShardedTrainStep(m, opt, nn.CrossEntropyLoss(), mesh, param_rules=fsdp_rules(mesh))
    losses = [float(step(x, y)) for x, y in inp["batches"][2:]]
    close(losses, got[0]["losses_a"][2:], 1e-4, 1e-5)
