"""nn.functional — the functions the serving slice's modules use
(counterpart of part of ``deepflows_tpu/nn/functional.py``).

Each follows the JAX package's arithmetic op for op, so f32 results agree
to rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..random import generator


def linear(input, weight, bias: Optional[torch.Tensor] = None):
    """``x @ W (+ b)`` with the reference's ``(in_features, out_features)``
    weight; the product is left to ``torch.matmul``."""
    out = input @ weight
    if bias is not None:
        out = out + bias
    return out


def gelu(input):
    """Exact (erf) GELU, ``0.5·x·(1 + erf(x/√2))``."""
    return 0.5 * input * (1.0 + torch.erf(input / math.sqrt(2.0)))


def softmax(input, dim: int = 1):
    """``exp(x - max) / sum`` in the input's dtype, as the JAX tape's
    softmax computes it."""
    e = torch.exp(input - torch.amax(input, dim, keepdim=True))
    return e / torch.sum(e, dim, keepdim=True)


def dropout(input, p: float = 0.5, training: bool = True):
    """Inverted dropout with a mask drawn from the package generator; the
    identity in eval mode or at ``p == 0``."""
    if not training or p == 0.0:
        return input
    keep = torch.empty_like(input).bernoulli_(
        1.0 - p, generator=generator(input.device)
    )
    return input * keep / (1.0 - p)
