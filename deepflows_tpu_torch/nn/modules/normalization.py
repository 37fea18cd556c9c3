"""LayerNorm, RMSNorm and GroupNorm (counterpart of
``deepflows_tpu/nn/modules/normalization.py``).  The statistics are taken
in the input's dtype, op for op as in the JAX package (so a bf16 input's
are bf16, where torch's own ``F.group_norm`` keeps them in f32)."""

from __future__ import annotations

import torch

from ...config import config
from ...device import Device
from ..parameter import Parameter
from .module import Module


class LayerNorm(Module):
    def __init__(
        self,
        normalized_shape,
        eps: float = 1e-5,
        elementwise_affine: bool = True,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            kw = dict(device=Device(device), dtype=dtype or config.default_dtype)
            self.weight = Parameter(torch.ones(self.normalized_shape, **kw))
            self.bias = Parameter(torch.zeros(self.normalized_shape, **kw))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        axes = tuple(range(x.dim() - len(self.normalized_shape), x.dim()))
        xc = x - x.mean(axes, keepdim=True)
        var = (xc * xc).mean(axes, keepdim=True)  # biased, like torch
        y = xc / (var + self.eps).sqrt()
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y

    def extra_repr(self) -> str:
        return (
            f"{self.normalized_shape}, eps={self.eps}, "
            f"elementwise_affine={self.elementwise_affine}"
        )


class RMSNorm(Module):
    """Root-mean-square norm, ``x / sqrt(mean(x²) + eps) · weight``: no
    centering and no bias (the Llama family's norm).  The mean square is
    taken in x's dtype, as the JAX package's tape ops take it."""

    def __init__(
        self,
        normalized_shape,
        eps: float = 1e-6,
        elementwise_affine: bool = True,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = Parameter(torch.ones(
                self.normalized_shape, device=Device(device),
                dtype=dtype or config.default_dtype,
            ))
        else:
            self.register_parameter("weight", None)

    def forward(self, x):
        axes = tuple(range(x.dim() - len(self.normalized_shape), x.dim()))
        ms = (x * x).mean(axes, keepdim=True)
        y = x / (ms + self.eps).sqrt()
        if self.weight is not None:
            y = y * self.weight
        return y

    def extra_repr(self) -> str:
        return (
            f"{self.normalized_shape}, eps={self.eps}, "
            f"elementwise_affine={self.elementwise_affine}"
        )


class GroupNorm(Module):
    """Normalise (N, C, *spatial) over each group of ``C / num_groups``
    channels together with every spatial position (torch's semantics).  No
    buffers: eval equals train.  ``weight`` and ``bias`` are ``(C,)``."""

    def __init__(
        self,
        num_groups: int,
        num_channels: int,
        eps: float = 1e-5,
        affine: bool = True,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(
                f"num_channels {num_channels} not divisible by "
                f"num_groups {num_groups}"
            )
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = float(eps)
        self.affine = affine
        if affine:
            kw = dict(device=Device(device), dtype=dtype or config.default_dtype)
            self.weight = Parameter(torch.ones((num_channels,), **kw))
            self.bias = Parameter(torch.zeros((num_channels,), **kw))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        N, C = x.shape[0], x.shape[1]
        xg = x.reshape(N, self.num_groups, -1)
        xc = xg - xg.mean(2, keepdim=True)
        var = (xc * xc).mean(2, keepdim=True)
        y = (xc / (var + self.eps).sqrt()).reshape(x.shape)
        if self.weight is not None:
            shape = (1, C) + (1,) * (x.dim() - 2)
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y

    def extra_repr(self) -> str:
        return (
            f"{self.num_groups}, {self.num_channels}, eps={self.eps}, "
            f"affine={self.affine}"
        )
