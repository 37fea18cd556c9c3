"""Checkpoints (counterpart of ``deepflows_tpu/utils/model_utils.py``).

A checkpoint is a pickle (``dill`` when it is installed, as in the JAX
package) of numpy arrays and Python scalars only, never a torch tensor, so
a file written by either package loads in the other.  Its layout is the JAX
package's::

    {"epoch", "loss",
     "model_parameters": {name: ndarray},
     "model_buffers": {name: ndarray},          # BatchNorm's running statistics
     "optimizer_state": {"type", "lr", ["momentum", "weight_decay"],
                         "v", "s", "t",          # the reference's Adam keys, t from 1
                         "full_state": {key: ndarray, list of them, or None}}}

``v`` and ``s`` are the very lists of ``full_state``, which pickle stores
once.  numpy has no bfloat16: a bf16 tensor is written as f32, which holds
it exactly, and a bf16 array from the JAX package (``ml_dtypes``) is read by
its bits.  Loading copies each array into the tensor of the same name in
place, cast to its dtype; the optimizer's state goes through
``utils.load_jax_optimizer_state``, from ``full_state`` or, in a
reference-layout file, from ``v`` / ``s`` / ``t``.

Writes are atomic (a temporary file, then ``os.replace``).  The
parameters and optimizer slots of a sharded run (DTensors,
``parallel.ShardedTrainStep``) are gathered whole: every rank calls
``save_checkpoint`` (or ``AsyncCheckpointer.save``), and rank 0 writes the
file, in the same layout.  Such a file loads into a fresh model and
optimizer, which a new ``ShardedTrainStep`` places on its mesh, of any
shape, or into a placed one: each DTensor parameter, buffer and slot
takes its own block (``convert.copy_into``).
``AsyncCheckpointer.save`` returns once it has copied the state on the
device; the copy to the host, the pickling and the write run on a
background thread while training goes on.  The JAX package's snapshot only
holds references, since its arrays are immutable; the port's optimizers
update in place, so a reference would let later steps into the file.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

try:
    import dill as pickle
except ImportError:  # pragma: no cover
    import pickle

from .convert import _from_numpy, copy_into, load_jax_optimizer_state


def _map(fn, v):
    if v is None:
        return None
    if isinstance(v, list):
        return [_map(fn, x) for x in v]
    return fn(v)


def _snapshot_state(model, optimizer, copy: bool) -> dict:
    """The model's parameters and buffers and the optimizer's state as
    detached tensors; with ``copy``, copies made on each tensor's device,
    and an event recorded after them on the card."""

    from torch.distributed.tensor import DTensor

    def grab(t):
        if isinstance(t, DTensor):
            return t.full_tensor()  # a collective: every rank takes part
        t = t.detach()
        return t.clone() if copy else t

    with torch.no_grad():
        snap = {
            "params": {n: grab(p) for n, p in model.named_parameters()},
            "buffers": {n: grab(b) for n, b in model.named_buffers()},
            "opt": None,
            "fence": None,
        }
        if optimizer is not None:
            opt = {"type": type(optimizer).__name__}
            for attr in ("lr", "momentum", "weight_decay"):
                if hasattr(optimizer, attr):
                    opt[attr] = getattr(optimizer, attr)
            optimizer._ensure_state()
            opt["state"] = {k: _map(grab, v) for k, v in optimizer._state.items()}
            snap["opt"] = opt
    if copy and torch.cuda.is_available() and torch.cuda.is_initialized():
        snap["fence"] = torch.cuda.Event()
        snap["fence"].record()
    return snap


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()  # exact: numpy has no bfloat16
    return t.cpu().numpy()


def _write_checkpoint(snap: dict, epoch, loss, save_path: str, extra) -> str:
    """Copy a snapshot to the host and write it atomically."""
    if snap["fence"] is not None:
        snap["fence"].synchronize()  # the device copies are done
    checkpoint = {
        "epoch": epoch,
        "loss": loss,
        "model_parameters": {n: _to_numpy(t) for n, t in snap["params"].items()},
        "model_buffers": {n: _to_numpy(t) for n, t in snap["buffers"].items()},
    }
    opt = snap["opt"]
    if opt is not None:
        opt_state = {k: v for k, v in opt.items() if k != "state"}
        full = {k: _map(_to_numpy, v) for k, v in opt["state"].items()}
        for key in ("v", "s"):
            if key in full:
                opt_state[key] = full[key]
        if "t" in full:
            opt_state["t"] = int(full["t"]) + 1  # the reference's t starts at 1
        opt_state["full_state"] = full
        checkpoint["optimizer_state"] = opt_state
    if extra:
        checkpoint.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    tmp = f"{save_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(checkpoint, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, save_path)
    return save_path


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only
    process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_checkpoint(model, optimizer=None, epoch: int = 0, loss: Optional[float] = None,
                    save_path: str = "checkpoint.pkl", extra: Optional[dict] = None) -> None:
    snap = _snapshot_state(model, optimizer, copy=False)
    if _writer():
        _write_checkpoint(snap, epoch, loss, save_path, extra)


class AsyncCheckpointer:
    """Checkpoint saves that do not stop training: ``save()`` copies the
    model's and the optimizer's state on the device (each tensor cloned,
    then an event recorded, without waiting for the device) and returns a
    ``concurrent.futures.Future``; one background thread waits for the
    event, copies to the host, pickles and renames.  The file holds the
    state of the moment ``save()`` was called, though the optimizer goes on
    updating in place.  At most ``max_pending`` saves are in flight (each
    holds one copy of the state on the device); one more waits for the
    oldest.

    Usage::

        with AsyncCheckpointer() as ck:
            for epoch in ...:
                train_epoch(...)
                ck.save(model, opt, epoch=epoch, save_path="ck.pkl")
        # leaving the block waits for the writes
    """

    def __init__(self, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="deepflows-ckpt")
        self._pending: list = []
        self._max_pending = max_pending

    def save(self, model, optimizer=None, epoch: int = 0, loss: Optional[float] = None,
             save_path: str = "checkpoint.pkl", extra: Optional[dict] = None):
        self._pending = [f for f in self._pending if not f.done()]
        while len(self._pending) >= self._max_pending:
            self._pending.pop(0).result()  # backpressure; raises a write's error
        snap = _snapshot_state(model, optimizer, copy=True)
        if not _writer():
            fut = Future()
            fut.set_result(None)
            return fut
        fut = self._pool.submit(_write_checkpoint, snap, epoch, loss, save_path, extra)
        self._pending.append(fut)
        return fut

    def wait(self) -> None:
        """Block until every save in flight is on disk (raises the first
        write error)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _copy_in(kind: str, named: dict, arrays: dict, strict: bool) -> None:
    with torch.no_grad():
        for name, arr in arrays.items():
            target = named.get(name)
            if target is None:
                if strict:
                    raise KeyError(f"checkpoint {kind} {name} not in model")
                continue
            src = _from_numpy(name, np.asarray(arr))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"size mismatch for {name}: checkpoint {tuple(src.shape)} vs "
                                 f"model {tuple(target.shape)}")
            copy_into(target, src)


def load_checkpoint(model, optimizer=None, load_path: str = "checkpoint.pkl",
                    strict: bool = True) -> dict:
    """Copy a checkpoint's parameters, buffers and (with ``optimizer``)
    optimizer state into ``model`` and ``optimizer`` on their devices;
    returns ``{"epoch", "loss"}``.  With ``strict``, a name the model lacks
    raises; a shape that differs raises either way, and so does optimizer
    state that does not fit the optimizer."""
    with open(load_path, "rb") as f:
        checkpoint = pickle.load(f)
    _copy_in("parameter", dict(model.named_parameters()),
             checkpoint.get("model_parameters", {}), strict)
    _copy_in("buffer", dict(model.named_buffers()), checkpoint.get("model_buffers", {}), strict)
    opt_state = checkpoint.get("optimizer_state")
    if optimizer is not None and opt_state is not None:
        for attr in ("lr", "momentum", "weight_decay"):
            if attr in opt_state and hasattr(optimizer, attr):
                setattr(optimizer, attr, opt_state[attr])
        full = opt_state.get("full_state")
        if full is None and "v" in opt_state and "s" in opt_state:
            # a reference-layout file: Adam's v and s ordered like the
            # optimizer's parameters, t counted from 1
            full = {"v": opt_state["v"], "s": opt_state["s"],
                    "t": int(opt_state.get("t", 1)) - 1}
        if full is not None:
            load_jax_optimizer_state(optimizer, full)
    return {"epoch": checkpoint.get("epoch", 0), "loss": checkpoint.get("loss")}
