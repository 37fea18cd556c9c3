"""Dropout (counterpart of ``deepflows_tpu/nn/modules/dropout.py``):
inverted scaling in training, the identity in eval mode."""

from __future__ import annotations

from .. import functional as F
from .module import Module


class Dropout(Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0 <= p < 1:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, self.training)

    def extra_repr(self):
        return f"p={self.p}"
