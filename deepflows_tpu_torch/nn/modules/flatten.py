"""Flatten (counterpart of ``deepflows_tpu/nn/modules/flatten.py``)."""

from __future__ import annotations

from .module import Module


class Flatten(Module):
    def __init__(self, start_dim: int = 1) -> None:
        super().__init__()
        self.start_dim = start_dim

    def forward(self, x):
        return x.flatten(self.start_dim)

    def extra_repr(self) -> str:
        return f"start_dim={self.start_dim}"
