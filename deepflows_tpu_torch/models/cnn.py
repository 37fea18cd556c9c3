"""Workload models of the reference's test scripts (counterpart of
``deepflows_tpu/models/cnn.py``): the MLP; the CNNs come with the CNN
slice."""

from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F


class MLP(nn.Module):
    """784→100→20→10 ReLU MLP (reference ``test/MLP_MNIST.py:72-80``).  Its
    layers are ``layers.0`` … ``layers.2``, the JAX package's keys."""

    def __init__(self, in_features=784, hidden=(100, 20), num_classes=10, device=None):
        super().__init__()
        dims = [in_features, *hidden, num_classes]
        self.layers = torch.nn.ModuleList(
            [nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:])]
        )

    def forward(self, x):
        if x.dim() > 2:
            x = x.flatten(1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
