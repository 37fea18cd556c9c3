"""Global configuration (counterpart of ``deepflows_tpu/config.py``).

- ``default_dtype``: float32, the JAX package's numerics contract.
- ``seed``: the seed of the package generators (``random.py``) when
  ``manual_seed`` was never called.

There is no kernel switch in the role of ``use_pallas``: the route follows
the tensor's device.  A CPU tensor takes a kernel's plain PyTorch twin, a
CUDA tensor takes the kernel.
"""

from __future__ import annotations

import os

import torch


class _Config:
    def __init__(self) -> None:
        self.default_dtype = torch.float32
        self.seed: int = int(os.environ.get("DEEPFLOWS_SEED", "0"))


config = _Config()
