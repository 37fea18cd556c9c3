"""Activations (counterpart of ``deepflows_tpu/nn/modules/activation.py``;
the tanh approximation of GELU comes with a later slice)."""

from __future__ import annotations

from typing import Optional

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


class ReLU6(Module):
    """``min(max(x, 0), 6)``, the MobileNet activation."""

    def forward(self, x):
        return F.relu6(x)


class Sigmoid(Module):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Module):
    def forward(self, x):
        return F.tanh(x)


class SiLU(Module):
    """``x · sigmoid(x)`` (``F.silu``)."""

    def forward(self, x):
        return F.silu(x)


class LeakyReLU(Module):
    def __init__(self, negative_slope: float = 1e-2) -> None:
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)

    def extra_repr(self) -> str:
        return f"negative_slope={self.negative_slope}"


class Softmax(Module):
    """Softmax along ``dim`` (None: axis 1, as in the JAX package)."""

    def __init__(self, dim: Optional[int] = None) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return F.softmax(x, 1 if self.dim is None else self.dim)

    def extra_repr(self) -> str:
        return f"dim={self.dim}"


class LogSoftmax(Softmax):
    """Log-softmax along ``dim`` (None: axis 1)."""

    def forward(self, x):
        return F.log_softmax(x, 1 if self.dim is None else self.dim)
