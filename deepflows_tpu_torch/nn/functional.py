"""nn.functional (counterpart of ``deepflows_tpu/nn/functional.py``).

Each follows the JAX package's arithmetic op for op, so f32 results agree
to rounding.  Convolution, batch norm and pooling are PyTorch's own ops
(cuDNN on the card), as the JAX package leaves them to XLA
(``lax.conv_general_dilated``, ``lax.reduce_window``) outside any Pallas
kernel; around them the JAX package's definitions are kept where torch's
differ: the batch variance is biased, pooling pads as ``reduce_window``
does, a pooling stride of 0 means the window.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import _data_axis as data_axis
from ..config import config
from ..ops.linear import linear_fused, matmul
from ..random import generator
from ..tensor import function_apply


class _FusedLinear(torch.autograd.Function):
    """``ops.linear_fused(x, w, b)`` forward; the closed-form backward of
    the JAX package's ``_FusedLinearOp`` (gx = g·wᵀ, gw = xᵀ·g, gb = Σ₀ g),
    its products through ``torch.matmul`` as JAX computes them outside
    Pallas."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_shape = b.shape
        return linear_fused(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = x.t() @ g if ctx.needs_input_grad[1] else None
        gb = g.sum(0).reshape(ctx.b_shape) if ctx.needs_input_grad[2] else None
        return gx, gw, gb


class _Matmul(torch.autograd.Function):
    """``ops.matmul(a, b)`` with both backward products through
    ``ops.matmul`` too, as the JAX package's matmul op routes them through
    ``BackendTensor @``; only the gradients asked for are computed."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = matmul(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = matmul(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def _eager_f32_route(*tensors) -> bool:
    x, w = tensors[:2]
    return (
        config.use_pallas
        and x.dim() == 2
        and w.dim() == 2
        and all(t.dtype == torch.float32 for t in tensors if t is not None)
    )


def linear(input, weight, bias: Optional[torch.Tensor] = None):
    """``x @ W (+ b)`` with the reference's ``(in_features, out_features)``
    weight.  With ``config.use_pallas`` a 2-D f32 input takes the port's
    kernels, as the JAX package's eager route takes its Pallas kernels:
    with a bias the whole affine is one ``ops.linear_fused``, without one
    the product is ``ops.matmul``.  Otherwise the product is left to
    ``torch.matmul``."""
    if _eager_f32_route(input, weight, bias):
        if bias is not None:
            return function_apply(_FusedLinear, input, weight, bias)
        return function_apply(_Matmul, input, weight)
    if input.dtype != weight.dtype:  # promote as JAX does: f32 x with bf16 W is f32
        dt = torch.promote_types(input.dtype, weight.dtype)
        input, weight = input.to(dt), weight.to(dt)
    out = input @ weight
    if bias is not None:
        out = out + bias
    return out


def relu(input):
    """``maximum(x, 0)``: a tie at 0 gives half the gradient, as the JAX
    package's maximum splits ties (``torch.relu`` would give none)."""
    return torch.maximum(input, input.new_zeros(()))


def relu6(input):
    """``min(max(x, 0), 6)``, the MobileNet activation; ties split the
    gradient as ``relu``'s do."""
    return torch.minimum(relu(input), input.new_full((), 6.0))


def leaky_relu(input, negative_slope: float = 0.01):
    """``maximum(x, slope · x)``."""
    return torch.maximum(input, input * negative_slope)


def sigmoid(input):
    return torch.sigmoid(input)


def tanh(input):
    return torch.tanh(input)


def silu(input):
    """``x · sigmoid(x)`` (the SwiGLU MLP's gate of the Llama family)."""
    return torch.nn.functional.silu(input)


def topk_mask(input, k: int):
    """0/1 mask, in the input's dtype, of each row's top-``k`` entries along
    the last axis.  Every entry tied at the k-th value is kept, so a row
    may keep more than ``k``.  The mask is constant under autograd:
    gradients flow through what it multiplies, not through the selection
    (the MoE routing of ``nn/modules/moe.py``)."""
    k = int(k)
    if not 1 <= k <= input.shape[-1]:
        raise ValueError(f"k={k} out of range for axis {input.shape[-1]}")
    x = input.detach()
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    return (x >= kth).to(input.dtype)


def gelu(input, approximate: str = "none"):
    """GELU: exact, ``0.5·x·(1 + erf(x/√2))``, or with ``approximate="tanh"``
    the tanh form ``0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³)))`` (GPT-2's
    ``gelu_new``), as the JAX package writes both."""
    if approximate == "tanh":
        inner = math.sqrt(2.0 / math.pi) * (input + 0.044715 * input**3)
        return 0.5 * input * (1.0 + torch.tanh(inner))
    return 0.5 * input * (1.0 + torch.erf(input / math.sqrt(2.0)))


def softmax(input, dim: int = 1):
    """``exp(x - max) / sum`` in the input's dtype, as the JAX tape's
    softmax computes it."""
    e = torch.exp(input - torch.amax(input, dim, keepdim=True))
    return e / torch.sum(e, dim, keepdim=True)


def dropout(input, p: float = 0.5, training: bool = True):
    """Inverted dropout with a mask drawn from the package generator; the
    identity in eval mode or at ``p == 0``.  Inside a sharded step the
    mask is drawn at the global batch's shape (dim 0 times the data axis's
    ranks, which share the generator's state) and this rank's rows kept:
    the unsharded step's mask."""
    if not training or p == 0.0:
        return input
    shape = (input.shape[0] * data_axis.size(),) + tuple(input.shape[1:])
    keep = torch.empty(shape, dtype=input.dtype, device=input.device).bernoulli_(
        1.0 - p, generator=generator(input.device)
    )
    return input * data_axis.local_rows(keep) / (1.0 - p)


def log_softmax(input, dim: int = 1):
    """``x - max - log(sum(exp(x - max)))`` along ``dim``."""
    shifted = input - torch.amax(input, dim, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim, keepdim=True))


def _maybe_one_hot(target, input, dim: int = 1, mask=None):
    """Integer class targets one-hot in the input's dtype, the class axis at
    ``dim``; a target of the input's shape is taken as is.  ``mask`` (the
    integer target's shape, bool) zeroes whole one-hot rows: the
    ``ignore_index`` mechanism."""
    target = torch.as_tensor(target, device=input.device)
    if tuple(target.shape) == tuple(input.shape):
        return target.to(input.dtype)
    num_classes = input.shape[dim] if input.dim() > 1 else input.shape[-1]
    oh = torch.nn.functional.one_hot(target.long(), num_classes).to(input.dtype)
    if mask is not None:
        oh = oh * mask[..., None].to(oh.dtype)
    if input.dim() > 1 and dim != input.dim() - 1:
        oh = oh.movedim(-1, dim)
    return oh


def cross_entropy(
    input, target, reduction: str = "mean", dim=None, ignore_index=None,
    label_smoothing: float = 0.0,
):
    """Stable log-softmax cross-entropy against one-hot (or integer)
    targets, with the semantics of the JAX package's ``cross_entropy``:

    - class-last ``(B, L, V)`` logits (with ``dim`` unset, or naming the
      last axis) flatten to ``(B·L, V)``; ``reduction='none'`` then returns
      the per-token ``(B, L)`` loss;
    - ``ignore_index`` (integer targets only): those positions contribute
      zero loss and ``'mean'`` divides by the count of the others (at
      least 1); inside a sharded step both sums span the global batch;
    - ``label_smoothing``: the one-hot target becomes ``(1 - eps)·onehot +
      eps / C``, ignored rows kept at zero;
    - otherwise ``'mean'`` divides by the number of positions (every axis
      but the class axis), ``'sum'`` sums, ``'none'`` sums over classes."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError("reduction must be 'mean', 'sum' or 'none'")
    target = torch.as_tensor(target, device=input.device)
    auto_ok = input.dim() == 3 if dim is None else dim in (-1, input.dim() - 1)
    if input.dim() > 2 and auto_ok:
        flat_int = tuple(target.shape) == tuple(input.shape[:-1])
        flat_oh = tuple(target.shape) == tuple(input.shape)
        if flat_int or flat_oh:
            seq_shape = tuple(input.shape[:-1])
            V = input.shape[-1]
            input = input.reshape(-1, V)
            target = target.reshape((-1, V) if flat_oh else (-1,))
            flat = cross_entropy(input, target, reduction, 1, ignore_index, label_smoothing)
            return flat.reshape(seq_shape) if reduction == "none" else flat
    dim = 1 if dim is None else dim % input.dim()
    valid = None
    if ignore_index is not None:
        if tuple(target.shape) == tuple(input.shape):
            raise ValueError("ignore_index requires integer class-index targets")
        valid = target != ignore_index
        # ignored ids -> class 0 for the one-hot; the mask zeroes the row
        target = _maybe_one_hot(target * valid, input, dim, mask=valid)
    else:
        target = _maybe_one_hot(target, input, dim)
    if label_smoothing:
        C = input.shape[dim]
        target = target * (1.0 - label_smoothing) + label_smoothing / C
        if valid is not None:
            target = target * valid.unsqueeze(dim).to(target.dtype)
    nll = -log_softmax(input, dim) * target
    if reduction == "none":
        return nll.sum(dim)
    total = nll.sum()
    if reduction == "sum":
        return total
    if valid is not None:
        count = data_axis.total(valid.sum().to(total.dtype))
        return data_axis.total(total) / count.clamp_min(1)
    return total * (1.0 / (nll.numel() // input.shape[dim]))


# ------------------------------------------------------------------ losses
def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError("reduction must be 'mean', 'sum' or 'none'")


def _target(target, input):
    """A loss target on the input's device; an array's floating values in
    the input's dtype, as the JAX tape converts them."""
    if isinstance(target, torch.Tensor):
        return target.to(input.device)
    t = torch.as_tensor(np.asarray(target), device=input.device)
    return t.to(input.dtype) if t.is_floating_point() else t


def l1_loss(input, target, reduction: str = "mean"):
    return _reduce(torch.abs(input - _target(target, input)), reduction)


def mse_loss(input, target, reduction: str = "mean"):
    return _reduce(torch.square(input - _target(target, input)), reduction)


def nll_loss(input, target, reduction: str = "mean"):
    """``-input * onehot(target)`` reduced over every element, as the JAX
    package (the reference's definition): integer targets are one-hot on
    axis 1, and ``'mean'`` divides by ``input.numel()``, not by the number
    of targets as torch's ``nll_loss`` does."""
    return _reduce(-input * _maybe_one_hot(_target(target, input), input), reduction)


def binary_cross_entropy(input, target, reduction: str = "mean", eps: float = 1e-7):
    """``-(t·log p + (1 - t)·log(1 - p))`` with the input clamped to
    ``[eps, 1 - eps]`` first (a clamped element gets no gradient; one on
    the bound gets half, as the JAX tape splits ties)."""
    lo, hi = (torch.tensor(v, dtype=input.dtype, device=input.device) for v in (eps, 1.0 - eps))
    p = torch.maximum(torch.minimum(input, hi), lo)
    t = _target(target, input)
    return _reduce(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)), reduction)


def one_hot(indices, num_classes: int, device=None):
    """``(…, num_classes)`` rows of the default float dtype, without
    gradients; on the indices' device when they are a tensor, else on
    ``device`` (the card by default)."""
    from ..device import Device

    if isinstance(indices, torch.Tensor):
        dev = indices.device if device is None else Device(device)
    else:
        dev = Device(device)
        indices = torch.as_tensor(np.asarray(indices))
    out = torch.nn.functional.one_hot(indices.to(dev).long(), num_classes)
    return out.to(config.default_dtype)


# ------------------------------------------------------------------ conv ops
def conv2d(x, weight, padding: int = 0, stride: int = 1, groups: int = 1):
    """``(N, Cin, H, W) × (Cout, Cin/groups, kh, kw)``, output in the
    input's dtype.  The argument order (padding, stride) is the
    reference's (``nn/modules/conv.py:104-108``)."""
    return torch.nn.functional.conv2d(
        x, weight, stride=stride, padding=padding, groups=groups)


def conv1d(x, weight, padding: int = 0, stride: int = 1, groups: int = 1):
    """``(N, Cin, L) × (Cout, Cin/groups, k)``."""
    return torch.nn.functional.conv1d(
        x, weight, stride=stride, padding=padding, groups=groups)


def batch_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Train-mode batch norm over every axis but the channel axis 1:
    returns ``(out, batch_mean, batch_var)``, the statistics of shape
    ``(C,)`` in f32 (in x's dtype for f32 and f64 x) and the variance
    BIASED, as the JAX package's (``backend/jax_kernels.py`` ``_bn_train``
    divides by n) and the reference's; ``out`` has x's dtype.

    torch's own batch norm (cuDNN on the card) computes all three: it is
    handed scratch running statistics at zero with momentum 1, so they
    come back as the batch's mean and unbiased variance, and the variance
    is scaled by (n - 1) / n.  A bf16 x is normalised with f32 weight and
    bias (its batch statistics in f32, where the JAX package keeps them in
    bf16)."""
    C = x.shape[1]
    n = x.numel() // C
    sdt = torch.float32 if x.dtype in (torch.float16, torch.bfloat16) else x.dtype
    if data_axis.current() is not None:
        return _batch_norm_global(x, weight, bias, eps, sdt)
    mean = torch.zeros(C, dtype=sdt, device=x.device)
    var = torch.zeros(C, dtype=sdt, device=x.device)
    w = None if weight is None else weight.reshape(C).to(sdt)
    b = None if bias is None else bias.reshape(C).to(sdt)
    out = torch.nn.functional.batch_norm(
        x, mean, var, w, b, training=True, momentum=1.0, eps=eps)
    return out, mean, var * ((n - 1) / n)


def _batch_norm_global(x, weight, bias, eps, sdt):
    """``batch_norm`` inside a sharded step (``_data_axis.scope``): the
    statistics of the global batch, each sum taken over the data axis's
    ranks (the mean first, then the squared deviations from it), as the
    JAX package's one program computes them."""
    C = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    shape = (1, C) + (1,) * (x.dim() - 2)
    n = x.numel() // C * data_axis.size()
    xs = x.to(sdt)
    mean = data_axis.total(xs.sum(dims)) / n
    xc = xs - mean.reshape(shape)
    var = data_axis.total((xc * xc).sum(dims)) / n
    out = xc * torch.rsqrt(var + eps).reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape).to(sdt) + bias.reshape(shape).to(sdt)
    return out.to(x.dtype), mean, var


def batch_norm_eval(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode batch norm on running statistics shaped like the channel
    axis (``(1, C, 1, 1)``): ``(x - rm) / sqrt(rv + eps)``, then the
    affine, cast back to x's dtype (``backend/jax_kernels.py``
    ``_bn_eval``)."""
    out = (x - running_mean) / torch.sqrt(running_var + eps)
    if weight is not None:
        out = out * weight + bias
    return out.to(x.dtype)


# ------------------------------------------------------------------ pool ops
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pool2d(x, kernel_size, stride, padding, pool, fill):
    """``pool`` over (kh, kw) windows; a padding past half the window, which
    torch's pooling refuses, is made by an explicit pad with ``fill``."""
    k, p = _pair(kernel_size), _pair(padding)
    s = _pair(stride) if stride else k
    if any(2 * pi > ki for pi, ki in zip(p, k)):
        x = torch.nn.functional.pad(x, (p[1], p[1], p[0], p[0]), value=fill)
        p = (0, 0)
    return pool(x, k, s, p)


def max_pool2d(x, kernel_size, stride=0, padding=0):
    """Max pooling whose padding is -inf (``reduce_window``'s init);
    ``stride=0`` means the window."""
    return _pool2d(x, kernel_size, stride, padding,
                   torch.nn.functional.max_pool2d, float("-inf"))


def avg_pool2d(x, kernel_size, stride=0, padding=0):
    """Average pooling that divides by the whole window, its zero padding
    included; ``stride=0`` means the window."""
    def pool(x, k, s, p):
        return torch.nn.functional.avg_pool2d(x, k, s, p, count_include_pad=True)

    return _pool2d(x, kernel_size, stride, padding, pool, 0.0)


def max_pool1d(x, kernel_size: int, stride: int = 0, padding: int = 0):
    s = stride or kernel_size
    return max_pool2d(x[..., None], (kernel_size, 1), (s, 1), (padding, 0))[..., 0]


def avg_pool1d(x, kernel_size: int, stride: int = 0, padding: int = 0):
    s = stride or kernel_size
    return avg_pool2d(x[..., None], (kernel_size, 1), (s, 1), (padding, 0))[..., 0]


def adaptive_avg_pool2d(x, output_size: int = 1):
    """Adaptive average pooling to ``output_size`` × ``output_size``: 1 is
    the mean over W, then over H; otherwise bins from floor(i·H/o) to
    ceil((i+1)·H/o), as torch's ``adaptive_avg_pool2d`` draws them."""
    if output_size == 1:
        return x.mean(3, keepdim=True).mean(2, keepdim=True)
    return torch.nn.functional.adaptive_avg_pool2d(x, output_size)


def flatten(x, start_dim: int = 1):
    return x.flatten(start_dim)
