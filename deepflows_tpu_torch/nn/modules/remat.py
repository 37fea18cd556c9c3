"""Activation checkpointing (counterpart of
``deepflows_tpu/nn/modules/remat.py``).

``Remat(block)``, or ``remat_call(block, x)`` without the wrapper, keeps
only the block's input between forward and backward and recomputes the
block in backward (``torch.utils.checkpoint``, non-reentrant), trading a
second forward for the memory of its activations.  Two rules of the JAX
package's remat hold here too:

- The recompute draws the same random numbers as the forward: the package
  generator of the input's device is set back to its state at the
  forward's start for the recompute, and put back afterwards.  (The port
  draws from no other generator, so torch's own are left alone.)
- Buffers are updated once: the forward updates BatchNorm's running
  statistics, the recompute does not (``recomputing()`` is true while it
  runs, and BatchNorm skips its EMA then).

In eval mode, or with gradients off, the block is called as it is.
"""

from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import checkpoint

from ...random import generator
from .module import Module

_local = threading.local()


def recomputing() -> bool:
    """True while a remat block is being recomputed in backward."""
    return getattr(_local, "depth", 0) > 0


def remat_call(module: Module, x, forward=None):
    """Run ``module``'s forward (or ``forward``, e.g. a block's
    ``_forward_impl``) on ``x`` as one checkpointed block, with the
    module's parameter and buffer names unchanged."""
    call = forward if forward is not None else module
    if not (torch.is_grad_enabled() and module.training):
        return call(x)
    gen = generator(x.device)
    start = gen.get_state()
    ran = []

    def block(x):
        if not ran:  # the forward
            ran.append(True)
            return call(x)
        now = gen.get_state()
        gen.set_state(start)
        _local.depth = getattr(_local, "depth", 0) + 1
        try:
            return call(x)
        finally:
            _local.depth -= 1
            gen.set_state(now)

    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)


class Remat(Module):
    """Wrap ``module`` so that its activations are recomputed in backward;
    the parameter names gain the ``module.`` prefix."""

    def __init__(self, module: Module):
        super().__init__()
        self.module = module

    def forward(self, x):
        return remat_call(self.module, x)
