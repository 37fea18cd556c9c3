"""Backend selection (counterpart of ``deepflows_tpu/backend_selection.py``).

One backend package, the device registry, selectable per tensor with
``device=``; ``DEEPFLOWS_BACKEND`` names the default device, which
``backend.device.default_device()`` re-reads on every call.
"""

import os

from . import backend as backend_api
from .backend import BackendTensor, Device, default_device

# the reference's informational name, read once at import
BACKEND = os.environ.get("DEEPFLOWS_BACKEND", "nd")

__all__ = ["BACKEND", "backend_api", "BackendTensor", "Device", "default_device"]
