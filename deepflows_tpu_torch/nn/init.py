"""Weight initializers (counterpart of ``deepflows_tpu/nn/init.py``).

They fill a tensor in place under ``no_grad`` with draws from the package
generator of the tensor's device (``random.generator``).

The fan convention is the JAX package's, copied exactly:
``fan_in = shape[1]`` and ``fan_out = shape[0]``.  For the ``(in, out)``
Linear weight that makes ``fan_in`` equal to ``out_features``, which is the
reference's quirk and not torch's rule.
"""

from __future__ import annotations

import math

import torch

from ..random import generator


@torch.no_grad()
def uniform_(tensor: torch.Tensor, low: float = 0.0, high: float = 1.0):
    return tensor.uniform_(low, high, generator=generator(tensor.device))


@torch.no_grad()
def normal_(tensor: torch.Tensor, mean: float = 0.0, std: float = 1.0):
    return tensor.normal_(mean, std, generator=generator(tensor.device))


def calculate_gain(nonlinearity: str, param=None) -> float:
    if nonlinearity in (
        "linear", "conv1d", "conv2d", "conv3d", "conv_transpose1d",
        "conv_transpose2d", "conv_transpose3d", "sigmoid",
    ):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        if param is None:
            negative_slope = 0.01
        elif isinstance(param, (int, float)) and not isinstance(param, bool):
            negative_slope = param
        else:
            raise ValueError(f"negative_slope {param} not a valid number")
        return math.sqrt(2.0 / (1 + negative_slope**2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"Unsupported nonlinearity {nonlinearity}")


def _calculate_fan_in_and_fan_out(tensor: torch.Tensor):
    if tensor.dim() < 2:
        raise ValueError(
            "Fan in and fan out can not be computed for tensor with fewer "
            "than 2 dimensions"
        )
    receptive_field_size = 1
    for s in tensor.shape[2:]:
        receptive_field_size *= s
    fan_in = tensor.shape[1] * receptive_field_size
    fan_out = tensor.shape[0] * receptive_field_size
    return fan_in, fan_out


def kaiming_uniform_(
    tensor: torch.Tensor, a: float = 0, mode: str = "fan_in",
    nonlinearity: str = "leaky_relu",
):
    mode = mode.lower()
    if mode not in ("fan_in", "fan_out"):
        raise ValueError(
            f"Mode {mode} not supported, please use fan_in or fan_out"
        )
    fan_in, fan_out = _calculate_fan_in_and_fan_out(tensor)
    fan = fan_in if mode == "fan_in" else fan_out
    bound = math.sqrt(3.0) * calculate_gain(nonlinearity, a) / math.sqrt(fan)
    return uniform_(tensor, -bound, bound)
