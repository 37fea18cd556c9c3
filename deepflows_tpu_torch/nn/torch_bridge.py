"""torch_function: run a function of plain torch tensors as one tape op
(the counterpart of ``deepflows_tpu/nn/jax_bridge.py``'s ``jax_function``,
which wraps JAX code; the port has no JAX to wrap).

The wrapped function becomes one autograd ``Function`` whose backward is
the function's vjp, routed to each tensor argument::

    swish = torch_function(lambda x: x * torch.sigmoid(1.702 * x))
    y = swish(t)                    # t: Tensor -> Tensor, grads flow

    @torch_function
    def custom(xw, b):              # any number of tensor arguments
        return torch.tanh(xw) + b

Rules, as ``jax_function``'s: ``fn`` takes tensors and returns one
tensor; it must be pure.  ``checkpoint=True`` keeps only the inputs and
recomputes the forward in the backward.  It runs through
``tensor.function_apply``, so under lazy mode it is one recorded node, and
``onnx.export_onnx`` refuses it as the JAX exporter refuses a
``_JaxFnOp`` (its body is opaque to the exporter).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..tensor import function_apply


class _TorchFn(torch.autograd.Function):
    """``y = fn(*tensors)``; the backward is ``fn``'s vjp, from the forward's
    saved graph or, with ``checkpoint``, from a recomputed one."""

    @staticmethod
    def forward(ctx, spec, *xs):
        fn, checkpoint = spec
        ctx.fn, ctx.checkpoint = fn, checkpoint
        if checkpoint or not any(ctx.needs_input_grad[1:]):
            if checkpoint:
                ctx.save_for_backward(*xs)
            with torch.no_grad():  # no gradient asked for: no vjp kept
                return fn(*xs)
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(x.is_floating_point()) for x in xs]
            y = fn(*ins)
        ctx.ins, ctx.y = ins, y
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        if ctx.checkpoint:
            with torch.enable_grad():
                ins = [x.detach().requires_grad_(x.is_floating_point())
                       for x in ctx.saved_tensors]
                y = ctx.fn(*ins)
        else:
            ins, y = ctx.ins, ctx.y
            ctx.ins = ctx.y = None  # one backward, as the JAX bridge's cached vjp
        wrt = [x for x in ins if x.requires_grad]
        grads = iter(torch.autograd.grad(y, wrt, g, allow_unused=True)) if wrt else iter(())
        return (None,) + tuple(next(grads) if x.requires_grad else None for x in ins)


def torch_function(fn: Callable = None, *, checkpoint: bool = False):
    """Wrap a function of torch tensors into one tape op (see the module
    docstring).  Usable as ``torch_function(fn)`` or as a decorator."""

    def make(f):
        @functools.wraps(f)
        def wrapped(*tensors):
            for t in tensors:
                if not isinstance(t, torch.Tensor):
                    raise TypeError("torch_function arguments must be tensors; close over "
                                    "Python constants instead")
            return function_apply(_TorchFn, (f, bool(checkpoint)), *tensors)

        return wrapped

    if fn is not None:
        return make(fn)
    return make
