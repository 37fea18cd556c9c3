"""Device resolution (counterpart of ``deepflows_tpu/backend/device.py``
``default_accelerator`` and ``Device``).

``device=None`` means the CUDA card.  Without a card, anything but an
explicit ``"cpu"`` raises: the JAX package's ``default_accelerator()`` falls
back to the CPU silently, and the port deliberately does not, so that a run
meant for the card never measures the host instead.
"""

from __future__ import annotations

import torch


def Device(name=None) -> torch.device:
    """Resolve ``name`` (None, ``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a
    ``torch.device``) to a ``torch.device``; raise if it names the card and
    no card is present."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {name!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def default_accelerator() -> torch.device:
    """The device entry points default to: the CUDA card, or an error."""
    return Device(None)
