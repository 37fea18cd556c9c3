"""Identity and the Linear layer (counterpart of
``deepflows_tpu/nn/modules/linear.py``).

The weight is ``(in_features, out_features)``, the reference's layout and
not torch's, and the bias is ``(1, out_features)``.  Init is
kaiming-uniform with ``a=√5`` under the JAX package's fan convention
(``nn/init.py``), and a bias bound of ``1/√in_features``.
"""

from __future__ import annotations

import math

import torch

from ...config import config
from ...device import Device
from .. import functional as F
from .. import init
from ..parameter import Parameter
from .module import Module


class Identity(Module):
    """Pass-through that takes any constructor arguments (torch's
    ``nn.Identity``); ``nn.fusion.fuse_conv_bn`` puts it in place of a
    folded BatchNorm."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__()

    def forward(self, input):
        return input


class Linear(Module):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=Device(device), dtype=dtype or config.default_dtype)
        self.weight = Parameter(
            torch.empty((in_features, out_features), **kw)
        )
        if bias:
            self.bias = Parameter(torch.empty((1, out_features), **kw))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            fan_in = self.in_features
            bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
            init.uniform_(self.bias, -bound, bound)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (
            f"in_features={self.in_features}, "
            f"out_features={self.out_features}, bias={self.bias is not None}"
        )
