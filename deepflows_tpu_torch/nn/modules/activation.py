"""Activations (counterpart of ``GELU``, ``ReLU``, ``SiLU`` and ``Tanh`` in
``deepflows_tpu/nn/modules/activation.py``; the tanh approximation of GELU
and the other activations come with later slices)."""

from __future__ import annotations

from .. import functional as F
from .module import Module


class GELU(Module):
    """Exact-erf GELU."""

    def forward(self, x):
        return F.gelu(x)


class ReLU(Module):
    """``maximum(x, 0)``, half the gradient at a tie (``F.relu``)."""

    def forward(self, x):
        return F.relu(x)


class Tanh(Module):
    def forward(self, x):
        return F.tanh(x)


class SiLU(Module):
    """``x · sigmoid(x)`` (``F.silu``)."""

    def forward(self, x):
        return F.silu(x)
