"""BatchNorm1d and BatchNorm2d (counterpart of
``deepflows_tpu/nn/modules/batchnorm.py``).

The JAX package's numerics: in training, the batch statistics over every
axis but the channel's, the variance biased, and an EMA of the running
statistics with momentum 0.1, ``running · (1 - m) + batch · m``, computed
here from those biased statistics (torch's own batch norm would update
``running_var`` with the unbiased variance); in eval, the running
statistics.  Weight, bias and the two running statistics have shape
``(1, C)`` plus a 1 for each spatial axis, and there is no
``num_batches_tracked`` buffer, so the state dict is the JAX package's.

The running statistics keep their dtype (f32) under a bf16 forward.  The
EMA is skipped while ``nn.Remat`` recomputes a block in backward, so it
runs once a step with or without remat.
"""

from __future__ import annotations

import torch

from ...config import config
from ...device import Device
from .. import functional as F
from ..parameter import Parameter
from .module import Module
from .remat import recomputing


class _BatchNormNd(Module):
    _dims = 2  # spatial axes

    def __init__(
        self,
        num_features: int,
        eps: float = 1e-5,
        momentum: float = 0.1,
        affine: bool = True,
        track_running_stats: bool = True,
        device=None,
        dtype=None,
    ) -> None:
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        shape = (1, num_features) + (1,) * self._dims
        kw = dict(device=Device(device), dtype=dtype or config.default_dtype)
        if affine:
            self.weight = Parameter(torch.ones(shape, **kw))
            self.bias = Parameter(torch.zeros(shape, **kw))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(shape, **kw))
            self.register_buffer("running_var", torch.ones(shape, **kw))
        else:
            self.register_buffer("running_mean", None)
            self.register_buffer("running_var", None)

    def forward(self, x):
        if self.training or not self.track_running_stats:
            out, mean, var = F.batch_norm(x, self.weight, self.bias, self.eps)
            if self.training and self.track_running_stats and not recomputing():
                m = self.momentum
                with torch.no_grad():
                    for buf, batch in ((self.running_mean, mean), (self.running_var, var)):
                        buf.copy_(buf * (1 - m) + batch.reshape(buf.shape) * m)
            return out
        return F.batch_norm_eval(
            x, self.weight, self.bias, self.running_mean, self.running_var, self.eps)

    def extra_repr(self) -> str:
        return (
            f"num_features={self.num_features}, eps={self.eps}, "
            f"momentum={self.momentum}, affine={self.affine}, "
            f"track_running_stats={self.track_running_stats}"
        )


class BatchNorm2d(_BatchNormNd):
    _dims = 2


class BatchNorm1d(_BatchNormNd):
    """Over ``(N, C)`` or ``(N, C, L)``; a 2-D input is normalised as
    ``(N, C, 1)``."""

    _dims = 1

    def forward(self, x):
        if x.dim() == 2:
            return super().forward(x[..., None])[..., 0]
        return super().forward(x)
