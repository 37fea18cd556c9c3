"""Process groups and device meshes (counterpart of
``deepflows_tpu/parallel/mesh.py``).

The JAX package names a mesh of devices inside one process; here each rank
is a process with one device, and a mesh is torch's ``DeviceMesh`` over the
ranks of the default process group, with the same axis names.
``init_process_group`` sets that group up: NCCL on the card (after
``torch.cuda.set_device``, so ``Device(None)`` names the rank's card), gloo
on the CPU.  The device is the caller's choice and nothing falls back.

A placement rule returns a ``PartitionSpec`` (``P``) as in the JAX package:
one mesh axis name, or None, per tensor dimension.  ``placements(mesh,
spec)`` turns it into DTensor placements, ``Shard(d)`` on the mesh axis a
dimension names and ``Replicate()`` on the others.  ``local_block`` is the
rank's part of a whole tensor under such placements, cut as
``torch.chunk`` cuts, as DTensor does.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import Device


class PartitionSpec(tuple):
    """One mesh axis name (or None, or a tuple of names) per tensor
    dimension; trailing dimensions left out are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

NamedSharding = namedtuple("NamedSharding", "mesh spec")
NamedSharding.__doc__ = "A mesh and a PartitionSpec on it (JAX's NamedSharding)."
NamedSharding.placements = property(lambda self: placements(self.mesh, self.spec))


def init_process_group(device=None, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       store=None, timeout=None) -> torch.device:
    """Join the default process group and return this rank's device.

    ``device`` is ``"cuda"`` (the default; NCCL, the card ``rank`` modulo
    the cards present, made current before anything is allocated) or
    ``"cpu"`` (gloo).  ``rank``,
    ``world_size``, ``init_method`` (or a ``store``) and ``timeout`` (a
    ``timedelta``) go to ``torch.distributed.init_process_group``."""
    dev = Device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", (rank or 0) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {} if store is not None else {"init_method": init_method}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, rank=rank, world_size=world_size, store=store,
                            device_id=dev if dev.type == "cuda" else None, **kw)
    return dev


def _device_type() -> str:
    """The mesh's device type: the default group's (NCCL: the card)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` from an ``{axis_name: size}`` dict, row-major over
    ``devices`` (global ranks; all of them by default).  Defaults to every
    rank on one ``data`` axis.  Every rank of the default group calls it,
    also one left out of ``devices``."""
    from torch.distributed.device_mesh import DeviceMesh

    devices = list(devices if devices is not None else range(dist.get_world_size()))
    if axes is None:
        axes = {"data": len(devices)}
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    n = 1
    for s in shape:
        n *= s
    if n != len(devices):
        raise ValueError(f"mesh {axes} needs {n} devices, have {len(devices)}")
    return DeviceMesh(_device_type(), torch.tensor(devices).reshape(shape),
                      mesh_dim_names=names)


def auto_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """data × model mesh over the first ``n_devices`` ranks."""
    n = n_devices or dist.get_world_size()
    assert n % model_parallel == 0
    return make_mesh({"data": n // model_parallel, "model": model_parallel}, range(n))


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh's axis ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def optimizer_state_shardings(state, slot_sharding, rep):
    """Shardings for an Optimizer state dict: per-parameter list entries get
    ``slot_sharding(i, value)``, scalar entries (step counters) are
    replicated."""
    out = {}
    for k, v in state.items():
        if isinstance(v, list):
            out[k] = [None if x is None else slot_sharding(i, x) for i, x in enumerate(v)]
        else:
            out[k] = rep
    return out


def placements(mesh, spec) -> tuple:
    """DTensor placements of a PartitionSpec: for each mesh axis,
    ``Shard(d)`` where dimension d names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for d, names in enumerate(spec):
        if names is None:
            continue
        for name in (names if isinstance(names, tuple) else (names,)):
            if name not in mesh.mesh_dim_names:
                raise ValueError(f"mesh has no axis {name!r}")
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(out)


def is_replicated(pl) -> bool:
    return all(p.is_replicate() for p in pl)


def local_block(full: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's block of ``full`` under placements ``pl`` (a view)."""
    for k, p in enumerate(pl):
        if p.is_shard():
            n, size = mesh.size(k), full.shape[p.dim]
            step = -(-size // n)
            start = min(size, mesh.get_local_rank(k) * step)
            full = full.narrow(p.dim, start, min(size, start + step) - start)
    return full


def as_dtensor(local: torch.Tensor, mesh, pl, shape):
    """A DTensor of global ``shape`` from this rank's block ``local``."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=stride)
