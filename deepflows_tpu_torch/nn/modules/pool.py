"""Pooling (counterpart of ``deepflows_tpu/nn/modules/pool.py``):
MaxPool1d/2d, AvgPool1d/2d and AdaptiveAvgPool2d.  A stride of 0 means
the kernel size."""

from __future__ import annotations

from .. import functional as F
from .module import Module


class _Pool(Module):
    _fn = None  # F's pooling function

    def __init__(self, kernel_size: int, stride: int = 0, padding: int = 0) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride else kernel_size
        self.padding = padding

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding)

    def extra_repr(self) -> str:
        return (
            f"kernel_size={self.kernel_size}, stride={self.stride}, "
            f"padding={self.padding}"
        )


class MaxPool1d(_Pool):
    _fn = staticmethod(F.max_pool1d)


class AvgPool1d(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class MaxPool2d(_Pool):
    _fn = staticmethod(F.max_pool2d)


class AvgPool2d(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AdaptiveAvgPool2d(Module):
    def __init__(self, output_size: int = 1) -> None:
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)

    def extra_repr(self) -> str:
        return f"output_size={self.output_size}"
