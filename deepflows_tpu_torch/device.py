"""Device resolution for the port's entry points: every ``device=``
argument goes through ``Device`` here, which returns the ``torch.device``
the entry point places its tensors on.  It is the registry's
(``backend/device.py``) ``Device(name).torch_device``, so it takes the same
names (``"gpu"`` and ``"tpu"`` name the card) and a registry
``BackendDevice`` too.

``device=None`` means the CUDA card, unless ``DEEPFLOWS_BACKEND=cpu``
asks for the CPU.  Without a card, anything but the CPU asked for raises:
the JAX package's ``default_accelerator()`` falls back to the CPU
silently, and the port deliberately does not, so that a run meant for the
card never measures the host instead.
"""

from __future__ import annotations

import torch

from .backend import device as _registry


def Device(name=None) -> torch.device:
    """Resolve ``name`` (None, ``"cuda"``, ``"cuda:1"``, ``"gpu"``,
    ``"tpu"``, ``"cpu"``, a ``torch.device`` or the registry's
    ``backend.BackendDevice``) to a ``torch.device``; raise if it names the
    card and no card is present."""
    return _registry.Device(name).torch_device


def default_accelerator() -> torch.device:
    """The device entry points default to: the CUDA card, or an error."""
    return _registry.default_accelerator().torch_device
