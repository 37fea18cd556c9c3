"""Conv1d, Conv2d and WSConv2d (counterpart of
``deepflows_tpu/nn/modules/conv.py``).

Square kernels with int stride and padding, and ``groups``.  The weight is
``(out, in/groups, k[, k])`` and the bias ``(1, out, 1[, 1])``, the
reference's shapes (not torch's ``(out,)`` bias), so state dicts cross
with no reshaping.  Init is kaiming-uniform with ``a=√5`` under the JAX
package's fan convention and a bias bound of ``1/√fan_in``.
"""

from __future__ import annotations

import math

import torch

from ...config import config
from ...device import Device
from .. import functional as F
from .. import init
from .module import Module


class _ConvNd(Module):
    _dims = 2

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        groups: int = 1,
        bias: bool = True,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(
                f"groups={groups} must divide in_channels={in_channels} and "
                f"out_channels={out_channels}"
            )
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.groups = groups
        kw = dict(device=Device(device), dtype=dtype or config.default_dtype)
        kshape = (out_channels, in_channels // groups) + (kernel_size,) * self._dims
        self.weight = torch.nn.Parameter(torch.empty(kshape, **kw))
        if bias:
            bshape = (1, out_channels) + (1,) * self._dims
            self.bias = torch.nn.Parameter(torch.empty(bshape, **kw))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            fan_in = (self.in_channels // self.groups) * self.kernel_size**self._dims
            bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
            init.uniform_(self.bias, -bound, bound)

    def _conv(self, x, weight):
        conv = F.conv2d if self._dims == 2 else F.conv1d
        out = conv(x, weight, self.padding, self.stride, self.groups)
        if self.bias is not None:
            out = out + self.bias
        return out

    def forward(self, x):
        return self._conv(x, self.weight)

    def extra_repr(self) -> str:
        s = (
            f"{self.in_channels}, {self.out_channels}, "
            f"kernel_size={self.kernel_size}, stride={self.stride}, "
            f"padding={self.padding}"
        )
        if self.groups != 1:
            s += f", groups={self.groups}"
        if self.bias is None:
            s += ", bias=False"
        return s


class Conv2d(_ConvNd):
    _dims = 2


class Conv1d(_ConvNd):
    _dims = 1


class WSConv2d(Conv2d):
    """Scaled weight-standardised conv (Brock et al. 2021, the NF-ResNets):
    ``W_hat = gain · gamma · (W - mean) / sqrt(fan_in · var + eps)`` per
    output channel, computed and differentiated through at every forward.
    ``gamma`` is the activation's signal-preserving constant and ``gain``
    (``(out, 1, 1, 1)``, ones) a learnable scale."""

    GAMMA_RELU = math.sqrt(2.0 / (1.0 - 1.0 / math.pi))

    def __init__(self, *args, gamma: float = 1.0, eps: float = 1e-4, **kw):
        super().__init__(*args, **kw)
        self.gamma = float(gamma)
        self.eps = float(eps)
        self.gain = torch.nn.Parameter(torch.ones(
            (self.out_channels, 1, 1, 1), dtype=self.weight.dtype,
            device=self.weight.device))

    def standardized_weight(self):
        w = self.weight
        fan_in = (self.in_channels // self.groups) * self.kernel_size**2
        mu = w.mean((1, 2, 3), keepdim=True)
        centered = w - mu
        var = (centered * centered).mean((1, 2, 3), keepdim=True)
        scale = (var * float(fan_in) + self.eps) ** -0.5
        return centered * (scale * (self.gain * self.gamma))

    def forward(self, x):
        return self._conv(x, self.standardized_weight())
