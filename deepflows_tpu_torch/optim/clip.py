"""Gradient clipping by global norm (counterpart of
``deepflows_tpu/optim/clip.py``).

``clip_grad_norm_(params, max_norm)`` clips ``p.grad`` eagerly and returns
the norm before clipping as a float.  ``clip_by_global_norm(max_norm)`` is
a ``grad_transform`` for ``jit.CompiledTrainStep``: its scale stays on the
device (``torch.where``, no host readback), as the JAX version's
``jnp.where`` stays in the traced program, so the step needs no sync.
"""

from __future__ import annotations

import torch


def _global_norm(grads):
    """sqrt of the sum of every gradient's sum of squares, or None when
    there is no gradient."""
    total = None
    for g in grads:
        if g is None:
            continue
        s = (g * g).sum()
        total = s if total is None else total + s
    return None if total is None else total**0.5


@torch.no_grad()
def clip_grad_norm_(params, max_norm: float) -> float:
    """Scale every ``p.grad`` so their global norm is at most ``max_norm``;
    returns the norm before clipping (0.0 without gradients)."""
    params = list(params)
    norm = _global_norm([p.grad for p in params])
    if norm is None:
        return 0.0
    if float(norm) > max_norm:
        scale = max_norm / (norm + 1e-6)
        for p in params:
            if p.grad is not None:
                p.grad = p.grad * scale.to(p.grad.dtype)
    return float(norm)


def clip_by_global_norm(max_norm: float):
    """A ``grad_transform``: scales the list of gradients (None entries
    kept) so their global norm is at most ``max_norm``."""

    def transform(grads):
        norm = _global_norm(grads)
        if norm is None:
            return grads
        scale = torch.where(norm > max_norm, max_norm / (norm + 1e-6), 1.0)
        return [None if g is None else g * scale.to(g.dtype) for g in grads]

    return transform
