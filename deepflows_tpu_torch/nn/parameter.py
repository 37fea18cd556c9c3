"""Parameter (counterpart of ``deepflows_tpu/nn/parameter.py``): a tensor that
always requires grad.

It is built with ``requires_grad=True`` whatever the grad mode, so a
parameter made under ``torch.no_grad`` or after ``Module.eval()`` still
trains.  ``numpy()`` is the tape ``Tensor``'s: a host copy (bf16 widened
to f32), where torch's refuses a tensor that requires grad.  ``name`` is
accepted for the JAX package's signature; torch tensors carry no name of
their own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import lazy as _lazy
from ..config import config


class Parameter(torch.nn.Parameter):
    def __new__(cls, data=None, name=None):
        if data is None:
            data = torch.empty(0, dtype=config.default_dtype)
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
            if data.is_floating_point():
                data = data.to(config.default_dtype)
        data = _lazy.force(data)  # made under lazy mode: a parameter holds its values
        return super().__new__(cls, data.detach(), requires_grad=True)

    def __deepcopy__(self, memo):
        # torch's own passes requires_grad where this signature has name
        if id(self) not in memo:
            out = type(self)(self.data.clone(memory_format=torch.preserve_format))
            out.requires_grad_(self.requires_grad)
            memo[id(self)] = out
        return memo[id(self)]

    def numpy(self, *, force=False) -> np.ndarray:
        from ..backend.torch_kernels import to_numpy

        return to_numpy(self)

    def __repr__(self):
        return f"Parameter({self.data}, device={self.device})"
