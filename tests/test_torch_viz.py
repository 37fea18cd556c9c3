"""The port's viz server (``deepflows_tpu_torch/viz/``) held against the
JAX package's (``tests/test_viz.py``'s cases), on the CPU (``device:
"cpu"`` in the training configs): the REST answers equal the JAX
server's, the dashboard's files are its bytes, the dynamic models carry
its weights to its outputs, a WebSocket training cycle runs, and the
digits arrays are scikit-learn's through the JAX package's transform."""

import json
import socket
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu.viz import make_server as jax_make_server
from deepflows_tpu.viz.server import build_dynamic_model as jax_build
from deepflows_tpu_torch.utils import load_jax_state_dict
from deepflows_tpu_torch.viz import build_dynamic_model, make_server
from deepflows_tpu_torch.viz.server import STATIC_ROOT, load_digits_images
from deepflows_tpu_torch.viz.websocket import encode_frame, read_frame

JAX_STATIC = Path(df.__file__).resolve().parent / "viz" / "static"
STATIC_FILES = sorted(str(p.relative_to(JAX_STATIC)) for p in JAX_STATIC.rglob("*")
                      if p.is_file())


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it."""
    from deepflows_tpu import config as jconfig
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = jconfig.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    yield
    jconfig.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager


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


def _serve(make):
    srv = make("127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"127.0.0.1:{srv.server_address[1]}", srv


def _stop(srv):
    srv.state.flags["stop"] = True
    srv.manager.stop_monitoring()
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def servers():
    """The port's server and the JAX package's, side by side."""
    port, jax = _serve(make_server), _serve(jax_make_server)
    yield port, jax
    for _, srv in (port, jax):
        _stop(srv)


@pytest.fixture()
def server():
    host, srv = _serve(make_server)
    yield host, srv
    _stop(srv)


def _post(host, path, payload=None):
    req = urllib.request.Request(
        f"http://{host}{path}", data=json.dumps(payload or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get(host, path):
    with urllib.request.urlopen(f"http://{host}{path}", timeout=10) as r:
        return r.read()


def _ws_connect(host):
    ip, port = host.split(":")
    sock = socket.create_connection((ip, int(port)), timeout=30)
    sock.sendall(
        b"GET /ws HTTP/1.1\r\nHost: " + host.encode() + b"\r\n"
        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
        b"Sec-WebSocket-Version: 13\r\n\r\n")
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    assert b"101" in resp.split(b"\r\n")[0]
    assert b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" in resp  # RFC 6455's sample accept
    return sock


def test_models_endpoint_equals_jax(servers):
    (host, _), (jhost, _) = servers
    data = json.loads(_get(host, "/api/models"))
    assert "MNIST_CNN" in data["models"]
    assert data == json.loads(_get(jhost, "/api/models"))
    assert json.loads(_get(host, "/api/history")) == {"runs": []}


def test_dashboard_served(servers):
    (host, _), _ = servers
    page = _get(host, "/")
    assert b"deepflows_tpu" in page and b"WebSocket" in page
    with pytest.raises(urllib.error.HTTPError):
        _get(host, "/../server.py")


@pytest.mark.parametrize("name", STATIC_FILES)
def test_static_files_are_the_jax_bytes(name, servers):
    (host, _), _ = servers
    want = (JAX_STATIC / name).read_bytes()
    assert (STATIC_ROOT / name).read_bytes() == want
    assert _get(host, "/" + name) == want


VALIDATE = [
    ([{"type": "Conv2d", "in_channels": 1, "out_channels": 8, "kernel_size": 3, "padding": 1},
      {"type": "MaxPool2d", "kernel_size": 2, "stride": 2}, {"type": "Flatten"},
      {"type": "Linear", "in_features": 8 * 14 * 14, "out_features": 10}], [1, 28, 28]),
    ([{"type": "Linear", "in_features": 16, "out_features": 32},
      {"type": "LayerNorm", "normalized_shape": 32}, {"type": "GELU"},
      {"type": "Reshape", "shape": [4, 8]},
      {"type": "MultiheadAttention", "embed_dim": 8, "num_heads": 2, "causal": True}], [16]),
]


def test_model_validate_endpoint_equals_jax(servers):
    (host, _), (jhost, _) = servers
    for layers, shape in VALIDATE:
        resp = _post(host, "/api/model/validate", {"layers": layers, "input_shape": shape})
        assert resp["ok"]
        assert resp == _post(jhost, "/api/model/validate",
                             {"layers": layers, "input_shape": shape})
    shapes = [s["output_shape"] for s in _post(host, "/api/model/validate", {
        "layers": VALIDATE[0][0], "input_shape": [1, 28, 28]})["shapes"]]
    assert shapes == [[1, 8, 28, 28], [1, 8, 14, 14], [1, 1568], [1, 10]]
    # a broken model reports its error instead of failing the request
    bad = {"layers": [{"type": "Linear", "in_features": 3, "out_features": 2}],
           "input_shape": [1, 28, 28]}
    got, want = _post(host, "/api/model/validate", bad), _post(jhost, "/api/model/validate", bad)
    assert not got["ok"] and got["error"] and not want["ok"]
    bad = {"layers": [{"type": "LSTM"}]}
    assert _post(host, "/api/model/validate", bad) == _post(jhost, "/api/model/validate", bad)


DYNAMIC = {
    "cnn": ([{"type": "Conv2d", "in_channels": 1, "out_channels": 4, "kernel_size": 3,
              "padding": 1},
             {"type": "ReLU"}, {"type": "MaxPool2d", "kernel_size": 2}, {"type": "Flatten"},
             {"type": "Linear", "in_features": 4 * 14 * 14, "out_features": 10}],
            (2, 1, 28, 28)),
    "transformer": ([{"type": "Linear", "in_features": 16, "out_features": 32},
                     {"type": "LayerNorm", "normalized_shape": 32}, {"type": "GELU"},
                     {"type": "MultiheadAttention", "embed_dim": 32, "num_heads": 2},
                     {"type": "Linear", "in_features": 32, "out_features": 4}], (2, 5, 16)),
    "tokens": ([{"type": "Flatten"}, {"type": "Linear", "in_features": 64, "out_features": 96},
                {"type": "Reshape", "shape": [3, 32]},
                {"type": "MultiheadAttention", "embed_dim": 32, "num_heads": 2, "causal": True},
                {"type": "Flatten"}, {"type": "Linear", "in_features": 96, "out_features": 10}],
               (2, 1, 8, 8)),
    "norms": ([{"type": "Conv2d", "in_channels": 3, "out_channels": 4, "padding": 1},
               {"type": "BatchNorm2d", "num_features": 4},
               {"type": "GroupNorm", "num_groups": 2, "num_channels": 4}, {"type": "ReLU6"},
               {"type": "AvgPool2d"}, {"type": "Dropout", "p": 0.5}], (2, 3, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(DYNAMIC))
def test_dynamic_model_with_jax_weights_equals_jax(name):
    layers, shape = DYNAMIC[name]
    df.manual_seed(0)
    jm = jax_build(layers, device="cpu")
    tm = build_dynamic_model(layers, device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm.eval()
    tm.eval()
    want = jm(df.Tensor(x, device="cpu")).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ws_broadcast(server):
    host, srv = server
    sock = _ws_connect(host)
    deadline = time.time() + 10
    while not srv.manager.connections and time.time() < deadline:
        time.sleep(0.05)
    assert srv.manager.connections
    srv.manager.broadcast({"type": "status", "data": "hello"})
    sock.settimeout(20)
    # with psutil installed the server's 1 Hz monitor broadcasts resources
    # frames, which may come before or after any other frame
    deadline = time.time() + 20
    msg = None
    while time.time() < deadline:
        opcode, payload = read_frame(sock)
        assert opcode == 1
        msg = json.loads(payload)
        if msg["type"] != "resources":
            break
    assert msg == {"type": "status", "data": "hello"}
    sock.sendall(encode_frame(b"", 0x8)[:1] + bytes([0x80]) + b"\x00\x00\x00\x00")
    deadline = time.time() + 20
    opcode = None
    while time.time() < deadline:
        opcode = read_frame(sock)[0]
        if opcode != 1:
            break
    assert opcode == 0x8  # the close is answered
    sock.close()


def _frames(sock, until, deadline_s=60):
    deadline = time.time() + deadline_s
    msgs = []
    while time.time() < deadline:
        frame = read_frame(sock)
        if frame is None:
            break
        msgs.append(json.loads(frame[1]))
        if until(msgs[-1]):
            break
    return msgs


def test_full_training_cycle(server):
    """Start, a metrics frame with a finite loss, a second start refused
    while running, stop."""
    host, srv = server
    sock = _ws_connect(host)
    sock.settimeout(60)
    resp = _post(host, "/api/train/start", {"epochs": 3, "num_samples": 512, "batch_size": 32,
                                            "device": "cpu"})
    assert resp["status"] == "started"
    msgs = _frames(sock, lambda m: m["type"] == "metrics")
    d = msgs[-1]["data"]
    assert msgs[-1]["type"] == "metrics" and {"epoch", "batch", "loss", "accuracy"} <= set(d)
    assert np.isfinite(d["loss"])
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(host, "/api/train/start", {"device": "cpu"})
    assert e.value.code == 409
    _post(host, "/api/train/stop")
    deadline = time.time() + 60
    while srv.state.flags["running"] and time.time() < deadline:
        time.sleep(0.1)
    assert not srv.state.flags["running"]
    assert srv.state.history[-1]["outcome"] == "stopped"
    sock.close()


def test_history_and_epoch_message(server):
    host, srv = server
    sock = _ws_connect(host)
    sock.settimeout(60)
    _post(host, "/api/train/start", {"epochs": 1, "num_samples": 256, "batch_size": 32,
                                     "scheduler": "cosine", "weight_decay": 1e-4,
                                     "device": "cpu", "optimizer": "adamw"})
    msgs = _frames(sock, lambda m: m["type"] == "status" and m["data"] in ("finished",
                                                                           "stopped"))
    epochs = [m for m in msgs if m["type"] == "epoch"]
    assert epochs and {"epoch", "test_acc", "lr", "epoch_time"} <= set(epochs[0]["data"])
    assert [m["data"] for m in msgs if m["type"] == "status"][-1] == "finished"
    deadline = time.time() + 30
    while srv.state.flags["running"] and time.time() < deadline:
        time.sleep(0.1)
    runs = json.loads(_get(host, "/api/history"))["runs"]
    assert runs and runs[-1]["outcome"] == "finished" and runs[-1]["test_acc"] is not None
    assert runs[-1]["config"]["optimizer"] == "adamw"
    sock.close()


def test_digits_equal_sklearn_through_the_jax_transform():
    """The port's copy of the optdigits data, read with numpy, gives the
    arrays of the JAX package's offline branch (``viz/server.py:208-214``)."""
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    x8 = d.images.astype(np.float32) / 16.0
    want = np.pad(np.kron(x8, np.ones((1, 3, 3), dtype=np.float32)), ((0, 0), (2, 2), (2, 2)))
    x, y = load_digits_images(limit=5000)
    assert x.shape == (1797, 1, 28, 28) and x.dtype == np.float32 and y.dtype == np.int32
    np.testing.assert_array_equal(x[:, 0], want)
    np.testing.assert_array_equal(y, d.target.astype(np.int32))
    x3, y3 = load_digits_images(limit=300)
    np.testing.assert_array_equal(x3, x[:300])
    np.testing.assert_array_equal(y3, y[:300])
