"""Conv → BatchNorm folding for inference (counterpart of
``deepflows_tpu/nn/fusion.py``).

``fuse_conv_bn(model, example_input)`` runs one forward of ``model`` on
``example_input`` to find every Conv1d, Conv2d or Linear whose output goes
to a BatchNorm1d or BatchNorm2d and nowhere else, folds the BN's running
statistics and affine into that layer's weight and bias, and puts
``nn.Identity`` in place of the BN.  Per out-channel c, in float64, then
cast to the parameter's dtype:

    s_c  = γ_c / sqrt(σ²_c + eps)
    W'_c = W_c · s_c
    b'_c = (b_c − μ_c) · s_c + β_c

The JAX package finds a conv output's consumers on its own tape.  Here a
``TorchFunctionMode`` counts the torch calls that take a conv's output
(the ops inside a BatchNorm's forward count as that BN, one consumer), so
a conv whose output also feeds a residual add keeps its BN.  Exact types
only: ``WSConv2d`` standardises its weight at every call and is never
folded.

Where the port is defined on purpose (the JAX version differs):
- a conv whose weight or bias Parameter is held by another module as well
  (tied) is not folded, so a shared weight is never scaled twice;
- the caller's grad mode and the caller's model's training flags are left
  as they were: the copy is put in eval (as the JAX version does) and
  ``inplace=True`` refuses a model with a BatchNorm in train mode rather
  than change its flags (the JAX version flips its process-wide grad flag
  in ``eval()`` and puts the caller's own model in eval).
"""

from __future__ import annotations

import copy
from collections import Counter

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .modules import BatchNorm1d, BatchNorm2d, Conv1d, Conv2d, Identity, Linear
from .modules.module import Module

__all__ = ["fuse_conv_bn"]

_PRODUCERS = (Conv1d, Conv2d, Linear)
_NORMS = (BatchNorm1d, BatchNorm2d)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class _Trace(TorchFunctionMode):
    """One forward: each producer's output and the torch calls that read it
    outside a BatchNorm's forward, each BN's inputs, each module's calls."""

    def __init__(self, model):
        super().__init__()
        self.outputs = {}  # id(output) -> [output, producer, consumers]
        self.bn_inputs = {}  # bn -> [input, ...]
        self.calls = Counter()
        self.bn_depth = 0
        self.hooks = []
        for m in model.modules():
            self.hooks.append(m.register_forward_pre_hook(self._called))
            if type(m) in _PRODUCERS:
                self.hooks.append(m.register_forward_hook(self._produced))
            elif type(m) in _NORMS:
                self.hooks.append(m.register_forward_pre_hook(self._bn_enter))
                self.hooks.append(m.register_forward_hook(self._bn_exit))

    def _called(self, mod, args):
        self.calls[mod] += 1

    def _produced(self, mod, args, out):
        if isinstance(out, torch.Tensor):
            self.outputs[id(out)] = [out, mod, 0]

    def _read(self, objs):
        for t in _tensors(objs):
            entry = self.outputs.get(id(t))
            if entry is not None and entry[0] is t:
                entry[2] += 1

    def _bn_enter(self, bn, args):
        if self.bn_depth == 0:
            self._read(args)  # the BN's forward is one consumer of its input
        self.bn_inputs.setdefault(bn, []).extend(_tensors(args))
        self.bn_depth += 1

    def _bn_exit(self, bn, args, out):
        self.bn_depth -= 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a call that returns no tensor (.shape, .dim()) only reads metadata
        if self.bn_depth == 0 and next(_tensors(out), None) is not None:
            self._read((args, kwargs))
        return out

    def remove(self):
        for h in self.hooks:
            h.remove()


@torch.no_grad()
def _fold(conv, bn) -> None:
    """Fold eval-mode ``bn`` into ``conv`` in place: float64, then each
    parameter's dtype."""
    c = bn.num_features
    f64 = dict(dtype=torch.float64, device=conv.weight.device)

    def vec(t, fill):
        return torch.full((c,), fill, **f64) if t is None else t.detach().to(**f64).reshape(c)

    mu, var = vec(bn.running_mean, 0.0), vec(bn.running_var, 1.0)
    gamma, beta = vec(bn.weight, 1.0), vec(bn.bias, 0.0)
    s = gamma / torch.sqrt(var + bn.eps)
    w = conv.weight.detach().to(**f64)
    if isinstance(conv, Linear):  # weight (in, out): scale the out axis
        new_w = w * s[None, :]
        bias_shape = (1, c)
    else:  # weight (out, in / groups, k[, k])
        new_w = w * s.reshape((c,) + (1,) * (w.dim() - 1))
        bias_shape = (1, c) + (1,) * conv._dims
    new_b = ((vec(conv.bias, 0.0) - mu) * s + beta).reshape(bias_shape)
    conv.weight.copy_(new_w)
    if conv.bias is not None:
        conv.bias.copy_(new_b)
    else:
        conv.bias = torch.nn.Parameter(new_b.to(conv.weight.dtype))


def fuse_conv_bn(model: Module, example_input, *, inplace: bool = False) -> Module:
    """Fold every eligible Conv/Linear → BatchNorm pair of ``model``.

    The forward runs on a copy put in eval or, with ``inplace``, on
    ``model`` itself, whose every BatchNorm must then be in eval already
    (ValueError otherwise).  A pair is folded only when all of these hold:

    - the BatchNorm has running statistics;
    - each module of the pair was called once in the forward;
    - the conv's output has no consumer other than the BatchNorm;
    - the conv's weight and bias are held by no other module.

    Returns the fused model, a deep copy unless ``inplace``.  Its eval
    forward equals the original's up to the rounding of the folded
    weights; it must not be trained further (the statistics are frozen
    into the convs)."""
    if not inplace:
        model = copy.deepcopy(model).eval()
    elif any(type(m) in _NORMS and m.training for m in model.modules()):
        raise ValueError("fuse_conv_bn(inplace=True) folds the running statistics, so every "
                         "BatchNorm must be in eval: call model.eval() first")
    if not isinstance(example_input, torch.Tensor):
        example_input = torch.as_tensor(np.asarray(example_input),
                                        device=next(model.parameters()).device)
    trace = _Trace(model)
    try:
        with torch.no_grad(), trace:
            model(example_input)
    finally:
        trace.remove()
    holders = Counter(id(p) for m in model.modules() for p in m._parameters.values()
                      if p is not None)
    parent_of = {id(child): (mod, name) for mod in model.modules()
                 for name, child in mod.named_children()}
    for bn, xs in trace.bn_inputs.items():
        if not bn.track_running_stats or bn.running_mean is None:
            continue
        if trace.calls[bn] != 1 or len(xs) != 1:
            continue
        entry = trace.outputs.get(id(xs[0]))
        if entry is None or entry[0] is not xs[0]:
            continue
        _, conv, consumers = entry
        if trace.calls[conv] != 1 or consumers != 1:
            continue  # called twice, or its output has other consumers
        if any(holders[id(p)] != 1 for p in (conv.weight, conv.bias) if p is not None):
            continue  # a tied weight would be folded into the other module too
        _fold(conv, bn)
        parent, name = parent_of[id(bn)]
        setattr(parent, name, Identity().eval())
    return model
