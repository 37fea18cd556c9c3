"""Embedding lookup (counterpart of ``deepflows_tpu/nn/modules/embedding.py``),
initialised N(0, 1) like torch's default."""

from __future__ import annotations

import torch

from ...config import config
from ...device import Device
from .. import init
from .module import Module


class Embedding(Module):
    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = torch.nn.Parameter(
            torch.empty(
                (num_embeddings, embedding_dim),
                device=Device(device), dtype=dtype or config.default_dtype,
            )
        )
        init.normal_(self.weight, 0.0, 1.0)

    def forward(self, idx):
        idx = torch.as_tensor(idx, device=self.weight.device)
        return self.weight[idx]

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"
