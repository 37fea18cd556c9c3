"""GELU (counterpart of ``GELU`` in ``deepflows_tpu/nn/modules/activation.py``;
the tanh approximation and the other activations come with later slices)."""

from __future__ import annotations

from .. import functional as F
from .module import Module


class GELU(Module):
    """Exact-erf GELU."""

    def forward(self, x):
        return F.gelu(x)
