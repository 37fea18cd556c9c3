"""Live-training visualization backend (counterpart of
``deepflows_tpu/viz/server.py``; reference: ``Visualization_backend/server.py``,
FastAPI + WebSocket + a Vue frontend).

The JAX package's HTTP and WebSocket contract on stdlib ``http.server``:

- ``POST /api/train/start`` {model?, optimizer?, scheduler?, learning_rate?,
  weight_decay?, epochs?, batch_size?, num_samples?, target_acc?, layers?,
  device?} starts a daemon training thread (409 while one runs);
- ``POST /api/train/stop`` sets the stop flag, read every batch;
- ``POST /api/model/validate`` {layers, input_shape?} builds the dynamic
  model and returns each layer's output shape;
- ``GET /api/models``, ``GET /api/history``;
- ``GET /`` the dashboard (``viz/static/``, the JAX package's files byte
  for byte), ``/js/*`` and ``/css/*`` its modules;
- ``WS /ws`` pushes ``{type: "metrics", data: {epoch, batch, loss,
  accuracy}}`` every 10 batches, ``{type: "status"}`` transitions and
  ``{type: "epoch", data: {epoch, test_acc, lr, epoch_time}}`` per epoch;
  ``{type: "resources"}`` at 1 Hz where ``psutil`` is installed, and none
  without it.

Training runs the port's ``CompiledTrainStep`` and ``CompiledEvalStep``
on the config's ``device``, ``"tpu"`` by default, which is the card here.
Data: the UCI optdigits set that scikit-learn bundles, kept in
``viz/data/digits.csv.gz`` and read with numpy, each 8×8 image upscaled
to 24×24 and padded to 28×28 as the JAX package's offline branch does.
The JAX package first tries OpenML's MNIST over the network; the port
makes no network call and needs no scikit-learn.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from .websocket import WSConnection, perform_handshake

STATIC_ROOT = Path(__file__).resolve().parent / "static"
DIGITS = Path(__file__).resolve().parent / "data" / "digits.csv.gz"

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".js": "text/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".ico": "image/x-icon",
}


def resolve_static(url_path: str) -> Optional[Path]:
    """Map a URL path onto ``viz/static/``, refusing traversal outside it.
    ``/`` serves the dashboard's shell; unknown extensions are refused."""
    if url_path in ("/", "/index.html"):
        return STATIC_ROOT / "index.html"
    candidate = (STATIC_ROOT / url_path.lstrip("/")).resolve()
    if (
        STATIC_ROOT not in candidate.parents
        or candidate.suffix not in _CONTENT_TYPES
        or not candidate.is_file()
    ):
        return None
    return candidate


class ConnectionManager:
    """Live WebSocket connections, JSON broadcast and the 1 Hz resource
    monitor (reference ``server.py:118-171``)."""

    def __init__(self):
        self.connections: list[WSConnection] = []
        self._lock = threading.Lock()
        self._monitoring = False

    def register(self, conn: WSConnection):
        with self._lock:
            self.connections.append(conn)

    def broadcast(self, message: dict):
        with self._lock:
            conns = list(self.connections)
        for c in conns:
            if not c.send_json(message):
                with self._lock:
                    if c in self.connections:
                        self.connections.remove(c)

    def start_monitoring(self):
        if self._monitoring:
            return
        self._monitoring = True

        def loop():
            try:
                import psutil
            except ImportError:
                return  # no resources messages without psutil
            while self._monitoring:
                self.broadcast({"type": "resources", "data": {
                    "cpu_percent": psutil.cpu_percent(),
                    "memory_percent": psutil.virtual_memory().percent}})
                time.sleep(1.0)

        threading.Thread(target=loop, daemon=True).start()

    def stop_monitoring(self):
        self._monitoring = False


def build_dynamic_model(layers, device=None):
    """A JSON layer list as a model (reference ``server.py:191-238``):
    Conv2d, ReLU, ReLU6, GELU, MaxPool2d, AvgPool2d, Flatten, Reshape,
    Linear, Dropout, BatchNorm2d, LayerNorm, GroupNorm, MultiheadAttention,
    the JAX package's set and names (so its state dict is the JAX
    model's)."""
    from .. import nn

    mods = []
    for spec in layers:
        t = spec["type"]
        if t == "Conv2d":
            mods.append(nn.Conv2d(spec["in_channels"], spec["out_channels"],
                                  spec.get("kernel_size", 3), spec.get("stride", 1),
                                  spec.get("padding", 0), device=device))
        elif t == "ReLU":
            mods.append(nn.ReLU())
        elif t == "MaxPool2d":
            mods.append(nn.MaxPool2d(spec.get("kernel_size", 2), spec.get("stride", 2)))
        elif t == "Flatten":
            mods.append(nn.Flatten())
        elif t == "Linear":
            mods.append(nn.Linear(spec["in_features"], spec["out_features"], device=device))
        elif t == "Dropout":
            mods.append(nn.Dropout(spec.get("p", 0.5)))
        elif t == "BatchNorm2d":
            mods.append(nn.BatchNorm2d(spec["num_features"], device=device))
        elif t == "ReLU6":
            mods.append(nn.ReLU6())
        elif t == "GELU":
            mods.append(nn.GELU())
        elif t == "AvgPool2d":
            mods.append(nn.AvgPool2d(spec.get("kernel_size", 2), spec.get("stride", 2)))
        elif t == "LayerNorm":
            mods.append(nn.LayerNorm(spec["normalized_shape"], device=device))
        elif t == "GroupNorm":
            mods.append(nn.GroupNorm(spec["num_groups"], spec["num_channels"], device=device))
        elif t == "MultiheadAttention":
            mods.append(nn.MultiheadAttention(spec["embed_dim"], spec["num_heads"],
                                              causal=spec.get("causal", False), device=device))
        elif t == "Reshape":
            shape = tuple(spec["shape"])

            class Reshape(nn.Module):
                def forward(self, x, _shape=shape):
                    return x.reshape((x.shape[0],) + _shape)

            mods.append(Reshape())
        else:
            raise ValueError(f"unsupported layer type {t}")
    return nn.Sequential(*mods)


def load_digits_images(limit: int = 3000):
    """``(x, y)``: the optdigits images as (N, 1, 28, 28) f32 in [0, 1] (8×8
    upscaled 3× and padded by 2) and their int32 labels, at most ``limit``."""
    with gzip.open(DIGITS, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    x8 = data[:, :-1].reshape(-1, 8, 8).astype(np.float32) / 16.0
    x24 = np.kron(x8, np.ones((1, 3, 3), dtype=np.float32))
    x = np.pad(x24, ((0, 0), (2, 2), (2, 2)))[:, None]
    return x[:limit], data[:limit, -1].astype(np.int32)


def infer_layer_shapes(layers, input_shape):
    """Each layer's output shape for the model builder's preview: the
    dynamic model built on the CPU, one zeros batch through each layer."""
    import torch

    model = build_dynamic_model(layers, device="cpu")
    x = torch.zeros((1, *input_shape), dtype=torch.float32)
    shapes = []
    with torch.no_grad():
        for spec, mod in zip(layers, model):
            x = mod(x)
            shapes.append({"type": spec["type"], "output_shape": list(x.shape)})
    return shapes


class TrainingState:
    def __init__(self):
        self.flags = {"running": False, "stop": False}
        self.thread: Optional[threading.Thread] = None
        self.history: list[dict] = []  # finished runs' summaries
        self.model = None  # the latest run's model


def _optimizer(name, params, lr, wd):
    from .. import optim

    opts = {
        "adam": lambda p: optim.Adam(p, lr=lr, weight_decay=wd),
        "sgd": lambda p: optim.SGD(p, lr=lr, momentum=0.9, weight_decay=wd),
        "adagrad": lambda p: optim.Adagrad(p, lr=lr),
        "adadelta": lambda p: optim.Adadelta(p, lr=lr),
        "adamw": lambda p: optim.AdamW(p, lr=lr, weight_decay=wd),
        "rmsprop": lambda p: optim.RMSprop(p, lr=lr, weight_decay=wd),
        "adafactor": lambda p: optim.Adafactor(p, lr=lr, weight_decay=wd),
        "lion": lambda p: optim.Lion(p, lr=lr, weight_decay=wd),
        "muon": lambda p: optim.Muon(p, lr=lr, weight_decay=wd),
    }
    return opts.get(name, opts["adam"])(params)


def train_worker(manager: ConnectionManager, state: TrainingState, config: dict):
    """The training loop that pushes metrics (reference ``server.py:263-383``)."""
    from .. import nn, optim
    from ..autograd import flag_kept
    from ..jit import CompiledEvalStep, CompiledTrainStep
    from ..utils.data import data_loader

    t_run = time.time()
    summary = {"config": {k: v for k, v in config.items() if k != "layers"},
               "started": time.strftime("%H:%M:%S"), "final_loss": None,
               "test_acc": None, "epochs_run": 0, "outcome": "error"}
    try:
        with flag_kept():  # the steps' eval() and train() set the tape's grad flag
            manager.broadcast({"type": "status", "data": "loading data"})
            x, y = load_digits_images(limit=int(config.get("num_samples", 3000)))
            n_test = max(1, len(x) // 6)
            x, x_test = x[:-n_test], x[-n_test:]
            y, y_test = y[:-n_test], y[-n_test:]
            device = config.get("device", "tpu")
            layers = config.get("layers")
            model_name = str(config.get("model", "MNIST_CNN"))
            if layers:
                model = build_dynamic_model(layers, device=device)
            elif model_name == "MLP":
                from ..models import MLP

                model = MLP(device=device)
            else:
                from ..models import MNIST_CNN

                model = MNIST_CNN(device=device)
            state.model = model
            lr = float(config.get("learning_rate", 1e-3))
            wd = float(config.get("weight_decay", 0.0))
            opt = _optimizer(str(config.get("optimizer", "adam")).lower(), model.parameters(),
                             lr, wd)
            epochs = int(config.get("epochs", 3))
            sch_name = str(config.get("scheduler", "none")).lower()
            scheduler = None
            if sch_name == "step":
                scheduler = optim.StepLR(opt, step_size=max(1, epochs // 3), gamma=0.5)
            elif sch_name == "cosine":
                scheduler = optim.CosineAnnealingLR(opt, T_max=epochs)
            target_acc = config.get("target_acc")

            def metrics_fn(out, yt):
                return {"acc": (out.argmax(1) == yt).float().mean()}

            step = CompiledTrainStep(model, opt, nn.CrossEntropyLoss(), metrics_fn=metrics_fn)
            ev = CompiledEvalStep(model)

            def test_accuracy():
                correct = 0
                for b in range(0, len(x_test), 256):
                    pred = ev(x_test[b:b + 256]).argmax(1).cpu().numpy()
                    correct += int((pred == y_test[b:b + 256]).sum())
                return correct / len(x_test)

            bs = int(config.get("batch_size", 64))
            manager.broadcast({"type": "status", "data": "training"})
            last_loss = float("nan")
            for epoch in range(epochs):
                t0 = time.time()
                loader = data_loader(x, y, bs, shuffle=True, drop_last=True, prefetch_size=2)
                for i, (xb, yb) in enumerate(loader):
                    if state.flags["stop"]:
                        summary["outcome"] = "stopped"
                        manager.broadcast({"type": "status", "data": "stopped"})
                        return
                    loss = step(xb, yb)
                    if i % 10 == 0:
                        last_loss = float(loss)
                        manager.broadcast({"type": "metrics", "data": {
                            "epoch": epoch, "batch": i, "loss": last_loss,
                            "accuracy": float(step._last_metrics["acc"])}})
                acc = test_accuracy()
                summary.update(final_loss=last_loss, test_acc=acc, epochs_run=epoch + 1)
                # a superset message (the reference pushes metrics, resources, status)
                manager.broadcast({"type": "epoch", "data": {
                    "epoch": epoch, "test_acc": acc, "lr": float(opt.lr),
                    "epoch_time": time.time() - t0}})
                if scheduler is not None:
                    scheduler.step()
                if target_acc is not None and acc * 100.0 >= float(target_acc):
                    summary["outcome"] = "target reached"
                    manager.broadcast({"type": "status",
                                       "data": f"target {target_acc}% reached"})
                    return
            summary["outcome"] = "finished"
            manager.broadcast({"type": "status", "data": "finished"})
    except Exception as e:  # surfaced to the dashboard
        summary["outcome"] = f"error: {e}"
        manager.broadcast({"type": "status", "data": f"error: {e}"})
    finally:
        summary["wall_time"] = round(time.time() - t_run, 2)
        state.history.append(summary)
        state.flags["running"] = False


AVAILABLE_MODELS = ["MNIST_CNN", "MLP", "dynamic"]


def make_server(host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    manager = ConnectionManager()
    state = TrainingState()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ws":
                if not perform_handshake(self):
                    return
                conn = WSConnection(self.connection)
                manager.register(conn)
                manager.start_monitoring()
                conn.serve_reads()  # blocks this handler's thread
                return
            if not self.path.startswith("/api/"):
                static = resolve_static(self.path.split("?", 1)[0])
                if static is None:
                    self._json({"error": "not found"}, 404)
                    return
                body = static.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPES[static.suffix])
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/api/models":
                self._json({"models": AVAILABLE_MODELS})
                return
            if self.path == "/api/history":
                self._json({"runs": state.history})
                return
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            try:
                config = json.loads(raw or b"{}")
            except json.JSONDecodeError:
                self._json({"error": "bad json"}, 400)
                return
            if self.path == "/api/train/start":
                if state.flags["running"]:
                    self._json({"status": "already running"}, 409)
                    return
                state.flags.update(running=True, stop=False)
                state.thread = threading.Thread(
                    target=train_worker, args=(manager, state, config), daemon=True)
                state.thread.start()
                self._json({"status": "started"})
                return
            if self.path == "/api/train/stop":
                state.flags["stop"] = True
                self._json({"status": "stopping"})
                return
            if self.path == "/api/model/validate":
                try:
                    shapes = infer_layer_shapes(config.get("layers") or [],
                                                tuple(config.get("input_shape", (1, 28, 28))))
                    self._json({"ok": True, "shapes": shapes})
                except Exception as e:
                    self._json({"ok": False, "error": str(e)})
                return
            self._json({"error": "not found"}, 404)

    server = ThreadingHTTPServer((host, port), Handler)
    server.manager = manager  # type: ignore[attr-defined]
    server.state = state  # type: ignore[attr-defined]
    return server


def main(host="0.0.0.0", port=8000):
    server = make_server(host, port)
    print(f"deepflows_tpu_torch viz backend on http://{host}:{port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
