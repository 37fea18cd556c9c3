"""Checks and device routing shared by the kernel wrappers.

A wrapper checks its operands with ``check``, then asks ``on_card`` where
they lie: CPU tensors go to the plain twin, CUDA tensors to the kernel,
which launches on the current stream inside ``on_device``.

The wrappers a whole step can run (flash attention, the fused CE, fused
Adam) state what one call costs with ``costed``: the operations the
function needs and the bytes it must move (each input read once, each
output written once), the counts ``chip_smoke.py`` takes its bounds from.
``utils.profiling.step_report`` reads them through a recorder in
``RECORDERS``; with none active the wrapper pays one list test.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

# active cost recorders (utils.profiling.step_report); the innermost is last
RECORDERS: list = []


class GraphHost:
    """Pinned host memory of one step that ``jit.StepGraphs`` captures:
    ``spare`` holds buffers its warm-up sets aside, by length, for the
    capture's host-to-card copies (pinning memory cannot be captured), and
    ``kept`` the buffers the captured copies read at every replay, which
    the graph keeps as long as it lives."""

    def __init__(self):
        self.spare, self.kept = {}, []


graph_host = None  # the GraphHost of the warm-up and capture in progress


def costed(cost):
    """Decorate a kernel wrapper with ``cost(*args, **kwargs) -> (operations,
    bytes)`` of one call; an active recorder gets ``kernel(name, ops,
    bytes)``, a context manager around the call."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not RECORDERS:
                return fn(*args, **kwargs)
            with RECORDERS[-1].kernel(fn.__name__, *cost(*args, **kwargs)):
                return fn(*args, **kwargs)

        wrapper.cost = cost
        return wrapper

    return wrap


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)

FLOATS = (torch.float32, torch.bfloat16)
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _dtensor_type():
    if not torch.distributed.is_available():
        return ()
    from torch.distributed.tensor import DTensor

    return DTensor


def on_card(*tensors) -> bool:
    """True when every operand lies on one CUDA card, False when all lie on
    the CPU; raises on a mix or on any other device, and on a DTensor: a
    kernel takes a rank's plain block (``parallel.ShardedTrainStep`` hands
    the model plain tensors), never a DTensor, on the card or off it."""
    dtensor = _dtensor_type()
    if any(isinstance(t, dtensor) for t in tensors):
        raise TypeError("a DTensor reached a kernel's entry; pass the rank's local tensors")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(
            f"operands lie on different devices: {[str(t.device) for t in tensors]}"
        )
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"  # meta tensors (lazy mode's shape inference) take the twin


def on_device(dev):
    """The kernel launches on the current device and stream: switch to the
    operands' card only when it is not already current."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(name, t, shape, dtypes, contiguous=True):
    """Raise unless ``t`` has ``shape`` (None matches any size), one of
    ``dtypes``, at least one element and, if asked, a contiguous layout."""
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
