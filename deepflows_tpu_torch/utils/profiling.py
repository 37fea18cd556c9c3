"""Tracing and cost reports (counterpart of ``deepflows_tpu/utils/profiling.py``),
on ``torch.profiler`` and ``torch.utils.flop_counter``.

- ``trace(log_dir)``: a profile of the block with CPU and, where there is a
  card, CUDA activities, written as a Chrome trace (Perfetto, TensorBoard)
  into ``log_dir``.
- ``StepTimer``: host step times; with ``sync_every=N`` every Nth step
  ends in ``torch.cuda.synchronize()``, so the times cover the device's
  work.
- ``device_memory_stats(i)``: the card's memory in the keys of JAX's
  ``memory_stats()``.
- ``step_report(step, *args)``: FLOPs and bytes of one step against the
  card's peaks (the roofline).  FLOPs come from ``FlopCounterMode`` over
  the step's aten ops; a kernel of the port is one call it cannot see, so
  each kernel wrapper's stated cost (``ops._common.costed``) is added, and
  whatever the kernel's plain twin runs on the CPU is left out, so the
  count is the same on both devices.  Bytes are every other aten op's
  inputs and outputs plus the kernels' stated bytes.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time
from typing import Optional

import torch

from ..backend import lazy as _lazy
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block into a Chrome trace in ``log_dir`` (by default
    ``deepflows_trace`` in the temporary directory), named
    ``<host>.<pid>.<ms>.pt.trace.json``:

    >>> with trace("runs/tr"):
    ...     step(x, y)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "deepflows_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """Rolling step timing: ``with timer: step(x, y)``.  With ``sync_every=N``
    the card is synchronised before every Nth step's time is taken."""

    def __init__(self, sync_every: int = 0):
        self.sync_every = sync_every
        self.times = []
        self._t = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if (self.sync_every and (len(self.times) + 1) % self.sync_every == 0
                and torch.cuda.is_available() and torch.cuda.is_initialized()):
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = sorted(self.times)
        n = len(arr)
        return {
            "steps": n,
            "mean_s": sum(arr) / n,
            "p50_s": arr[n // 2],
            "p95_s": arr[min(n - 1, int(n * 0.95))],
        }


def device_memory_stats(device_index=0) -> Optional[dict]:
    """The card's memory in the keys of JAX's ``memory_stats()``:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, now and at peak) and ``bytes_limit`` (the card's total
    memory).  ``device_index`` is a card's index or a device; None for the
    CPU, or without a card."""
    dev = torch.device("cuda", device_index) if isinstance(device_index, int) \
        else torch.device(device_index)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
    }


# dense bf16 TFLOP/s and memory GB/s by a substring of the card's name
# (NVIDIA's data sheets, SXM parts; the same numbers as chip_smoke.py)
_PEAKS = [("h100", 989.0, 3350.0)]


def _lookup(kind: str):
    kind = kind.lower()
    for sub, tflops, gbs in _PEAKS:
        if sub in kind:
            return tflops, gbs
    return None, None


# aten ops that move no element bytes: views, allocations, scalar reads
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like", "new_empty", "detach",
                       "lift_fresh", "_local_scalar_dense", "set_", "record_stream"))


class _Cost(TorchDispatchMode):
    """Bytes of every aten op outside the port's kernels, and each kernel's
    stated cost (``ops._common.RECORDERS``)."""

    def __init__(self, flop_counter):
        super().__init__()
        self.flop_counter = flop_counter
        self.bytes = 0
        self.paused = 0
        self.hidden_flops = 0  # what the counter saw inside a kernel's twin
        self.kernels = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not self.paused and not getattr(func, "is_view", False)
                and func.__name__.split(".")[0] not in _NO_BYTES):
            leaves = tree_leaves((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out

    @contextlib.contextmanager
    def kernel(self, name, ops, nbytes):
        before = self.flop_counter.get_total_flops()
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1
            self.hidden_flops += self.flop_counter.get_total_flops() - before
            calls, o, b = self.kernels.get(name, (0, 0, 0))
            self.kernels[name] = (calls + 1, o + ops, b + nbytes)


def _clone_state(v):
    if isinstance(v, list):
        return [_clone_state(x) for x in v]
    return v.clone() if isinstance(v, torch.Tensor) else v


@_lazy.eager
def step_report(step, *example_args) -> dict:
    """Cost of one call of a ``CompiledTrainStep`` or ``CompiledEvalStep``
    on ``example_args``: FLOPs, bytes, arithmetic intensity and, on a card
    of the peak table, the roofline's least step time.

    >>> rep = step_report(train_step, x, y)
    >>> print(rep["summary"])

    The step runs once; a train step's parameters, buffers, optimizer state
    and the package generator of its device are put back as they were, so
    the report changes nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import _common
    from ..random import generator

    model = step.model
    dev = next(model.parameters()).device
    train = hasattr(step, "optimizer")
    if train:
        opt = step.optimizer
        opt._ensure_state()
        saved = [t.detach().clone() for t in model.state_dict(keep_vars=True).values()]
        saved_opt = {k: _clone_state(v) for k, v in opt._state.items()}
        saved_rng = generator(dev).get_state()
    counter = FlopCounterMode(display=False)
    cost = _Cost(counter)
    _common.RECORDERS.append(cost)
    try:
        with counter, cost:
            step(*example_args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        _common.RECORDERS.remove(cost)
        if train:
            with torch.no_grad():
                for t, s in zip(model.state_dict(keep_vars=True).values(), saved):
                    t.copy_(s)
            opt._state = saved_opt
            generator(dev).set_state(saved_rng)
    flops = float(counter.get_total_flops() - cost.hidden_flops
                  + sum(o for _, o, _ in cost.kernels.values()))
    byts = float(cost.bytes + sum(b for _, _, b in cost.kernels.values()))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rep = {
        "device_kind": kind,
        "flops_per_step": flops,
        "bytes_per_step": byts,
        "arithmetic_intensity": flops / byts if byts else None,
        "kernels": {name: dict(calls=c, flops=o, bytes=b)
                    for name, (c, o, b) in cost.kernels.items()},
    }
    peak, hbm = _lookup(kind)
    if peak and byts:
        t_compute = flops / (peak * 1e12)
        t_memory = byts / (hbm * 1e9)
        bound = "memory-bandwidth" if t_memory > t_compute else "compute"
        rep.update(
            compute_bound_ms=t_compute * 1e3,
            memory_bound_ms=t_memory * 1e3,
            roofline_ms=max(t_compute, t_memory) * 1e3,
            bound=bound,
        )
        rep["summary"] = (
            f"{flops / 1e9:.2f} GFLOP, {byts / 1e9:.2f} GB/step, "
            f"AI={flops / byts:.1f} FLOP/B on {kind}: {bound}-bound, "
            f"roofline >= {rep['roofline_ms']:.2f} ms/step"
        )
    else:
        rep["summary"] = f"{flops / 1e9:.2f} GFLOP, {byts / 1e9:.2f} GB/step"
    return rep
