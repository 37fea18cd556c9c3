"""Purification: a module's forward as a function of the tensors that stand
for its parameters and buffers (counterpart of
``deepflows_tpu/purify.py``).

The JAX package swaps arrays into a tape module under its trace lock so
that ``jax.grad`` can differentiate the call.  PyTorch is eager and
differentiates any call, so here the swap is ``torch.func.functional_call``:
the given tensors stand in for the module's parameters and buffers for one
call, and autograd records through them.  The names are kept so a reader
finds the counterpart; no lock is needed.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.func import functional_call

from . import random as df_random


def _names(named, objs, kind):
    by_id = {id(t): n for n, t in named}
    try:
        return [by_id[id(t)] for t in objs]
    except KeyError:
        raise ValueError(f"a {kind} given is not one of the module's") from None


def _saved_generators():
    return {dev: g.get_state() for dev, g in df_random._generators.items()}


def _restore_generators(saved):
    for dev, g in list(df_random._generators.items()):
        if dev in saved:
            g.set_state(saved[dev])
        else:
            del df_random._generators[dev]


def purified_call(
    call: torch.nn.Module,
    params: Sequence,
    buffers: Sequence,
    param_tensors,
    buffer_tensors,
    x,
):
    """Run ``call(x)`` with ``param_tensors`` in place of the module's
    parameters ``params`` and ``buffer_tensors`` in place of its buffers
    ``buffers`` (the module's own tensors, matched by identity), and return
    ``(y, new_buffers)``.  The buffers are copied first, so an update in
    place (BatchNorm's running statistics) lands in the copies that are
    returned and never in ``buffer_tensors``.  The module's own parameters
    and buffers, its train/eval mode and the package generators are as they
    were afterwards."""
    names = _names(call.named_parameters(), params, "parameter")
    bnames = _names(call.named_buffers(), buffers, "buffer")
    return call_by_names(call, names, bnames, param_tensors, buffer_tensors, x)


def call_by_names(call, names, bnames, param_tensors, buffer_tensors, x):
    """``purified_call`` with the parameters and buffers named (the names
    of ``call.named_parameters()`` and ``named_buffers()``), so a caller
    that resolved them once keeps working after the module's tensors are
    replaced (a sharded step places them anew)."""
    bound = dict(zip(names, param_tensors))
    new_bufs = [b.detach().clone() for b in buffer_tensors]
    bound.update(zip(bnames, new_bufs))
    saved = _saved_generators()
    try:
        y = functional_call(call, bound, (x,), strict=False)
    finally:
        _restore_generators(saved)
    return y, new_bufs


def purify_fn(fn: Callable) -> Callable:
    """``fn`` (a criterion) as a function of tensors: arguments that are not
    tensors become tensors on the device of the first that is, and the
    package generators are as they were afterwards."""

    def pure(*args):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
        args = [a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=dev)
                for a in args]
        saved = _saved_generators()
        try:
            return fn(*args)
        finally:
            _restore_generators(saved)

    return pure
