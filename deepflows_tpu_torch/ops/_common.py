"""Checks and device routing shared by the kernel wrappers.

A wrapper checks its operands with ``check``, then asks ``on_card`` where
they lie: CPU tensors go to the plain twin, CUDA tensors to the kernel,
which launches on the current stream inside ``on_device``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

FLOATS = (torch.float32, torch.bfloat16)
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def on_card(*tensors) -> bool:
    """True when every operand lies on one CUDA card, False when all lie on
    the CPU; raises on a mix or on any other device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(
            f"operands lie on different devices: {[str(t.device) for t in tensors]}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


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
