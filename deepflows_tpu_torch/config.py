"""Global configuration (counterpart of ``deepflows_tpu/config.py``).

- ``default_dtype``: float32, the JAX package's numerics contract.
- ``use_pallas``: read from ``DEEPFLOWS_USE_PALLAS`` (``"1"`` turns it on;
  off by default), the JAX package's switch of the same name.  It picks
  whether two eager routes take the port's hand-written kernels or
  ``torch.matmul``, as it picks Pallas or XLA in the JAX package: a 2-D f32
  ``nn.functional.linear`` with a bias runs as one ``ops.linear_fused``,
  and without a bias as ``ops.matmul``, its two backward products too.
  ``jit.CompiledTrainStep`` and ``CompiledEvalStep`` turn it off for their
  call, as the JAX package's traced steps never take these routes.  The
  device still picks between a kernel and its plain twin: a CPU tensor
  takes the twin, a CUDA tensor the kernel.
- ``seed``: the seed of the package generators (``random.py``) when
  ``manual_seed`` was never called.
"""

from __future__ import annotations

import os

import torch


class _Config:
    def __init__(self) -> None:
        self.default_dtype = torch.float32
        self.use_pallas: bool = os.environ.get("DEEPFLOWS_USE_PALLAS", "0") == "1"
        self.seed: int = int(os.environ.get("DEEPFLOWS_SEED", "0"))


config = _Config()
