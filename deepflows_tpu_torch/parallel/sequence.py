"""Sequence parallelism by layout constraints (counterpart of
``deepflows_tpu/parallel/sequence.py``).

In the JAX package a ``ShardConstraint`` pins the layout of an activation
and of its cotangent inside the one global program.  ``ShardedTrainStep``
here runs the model on plain tensors (each rank its rows, the weights
gathered whole), and no step of the port makes DTensor activations, so a
constraint is the identity: the model trains as it would without it, and
it saves no memory.  It refuses a DTensor.  It keeps models written for
the JAX package's sequence sharding running unchanged::

    sp = sequence_sharding(mesh, axis="model", dim=1)  # (B, L, E): shard L
    model = nn.Sequential(sp, block0, sp, block1, sp)

The ring (``ring_attention``) is the port's sequence parallelism.
"""

from __future__ import annotations

import torch

from .mesh import P, placements


class ShardConstraint(torch.nn.Module):
    """Parameter-less module standing where the JAX package pins an
    activation's layout; the identity under ``ShardedTrainStep``."""

    def __init__(self, mesh, spec):
        super().__init__()
        self.mesh = mesh
        self.spec = P(*spec)
        placements(mesh, self.spec)  # refuses an axis the mesh lacks

    def forward(self, x):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            raise TypeError("ShardConstraint is the identity on the plain tensors "
                            "ShardedTrainStep runs; it does not place a DTensor")
        return x

    def __repr__(self):
        return f"ShardConstraint({self.spec}, identity under ShardedTrainStep)"


def sequence_sharding(mesh, axis: str = "model", dim: int = 1,
                      batch_axis: str = "data") -> ShardConstraint:
    """Constraint for (B, L, ...) activations: batch over ``batch_axis``,
    the sequence dim over ``axis``, the rest replicated."""
    spec = [None] * (dim + 1)
    spec[0] = batch_axis if batch_axis in mesh.mesh_dim_names else None
    spec[dim] = axis
    return ShardConstraint(mesh, P(*spec))
