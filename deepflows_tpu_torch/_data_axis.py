"""The data axis of a sharded step, for the operations that couple a
batch's rows.

The JAX package's sharded step is one global program, so BatchNorm's
statistics, a cross-entropy mean over the positions ``ignore_index``
keeps, a dropout mask, the MoE balancing loss and the Switch capacity
span every row of the global batch.  ``parallel.ShardedTrainStep`` runs
each rank's forward and backward on its rows inside ``scope(group, size,
rank)``; the operations then use these functions, which reduce over the
ranks of the data axis and are differentiable, as the one program would
be:

- ``total(t)``: the sum over the ranks; ``mean(t)``: the mean over the
  ranks of a per-rank mean;
- ``before(t)``: the sum over the ranks before this one (not
  differentiable: counts);
- ``size()``: the number of ranks; ``local_rows(t)``: this rank's rows of
  a tensor shaped for the global batch (dim 0 in rank order).

Outside a scope the batch is whole: each is the identity (``before`` is
zero, ``size`` is 1), so a model runs unchanged.  The backward of a sum
over the ranks is a sum over the ranks: every rank's loss uses the reduced
value, and the step sums the ranks' gradients.  This module sits below
``nn``; ``parallel`` sets the scope and ``nn`` reads it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Scope(NamedTuple):
    group: object
    size: int
    rank: int


_SCOPES: list = []


@contextlib.contextmanager
def scope(group, size: int, rank: int):
    _SCOPES.append(Scope(group, size, rank))
    try:
        yield
    finally:
        _SCOPES.pop()


def current() -> Optional[Scope]:
    return _SCOPES[-1] if _SCOPES else None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def size() -> int:
    s = current()
    return 1 if s is None else s.size


def total(t: torch.Tensor) -> torch.Tensor:
    s = current()
    return t if s is None else _Sum.apply(t, s.group)


def mean(t: torch.Tensor) -> torch.Tensor:
    s = current()
    return t if s is None else _Sum.apply(t, s.group) / s.size


def before(t: torch.Tensor) -> torch.Tensor:
    s = current()
    if s is None:
        return torch.zeros_like(t)
    parts = [torch.empty_like(t) for _ in range(s.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=s.group)
    return sum(parts[:s.rank], torch.zeros_like(t))


def local_rows(t: torch.Tensor) -> torch.Tensor:
    s = current()
    return t if s is None else t.chunk(s.size, 0)[s.rank]
