"""Mesh-parallel training and evaluation (counterpart of
``deepflows_tpu/parallel/sharded.py``): ``ShardedTrainStep``,
``ShardedEvalStep`` and the placement rules.

The JAX package's sharded step is one global program whose collectives
XLA's partitioner inserts.  Here each rank is a process, and the step
spells the same semantics out:

- Between steps every parameter is a DTensor ``Parameter`` placed by
  ``param_rules(name, shape) -> PartitionSpec`` (replicated without
  rules): each rank stores its block.  Optimizer slots are placed like
  their parameter, or, with ``zero_shard_state``, the slots of a
  replicated parameter over the data axis (dim 0, when it divides).
  Buffers stay plain tensors, the same on every rank.
- ``step(x, y)`` takes the global batch on every rank.  It gathers each
  parameter whole (cast to ``compute_dtype``), binds the plain copies into
  the model, and runs forward and backward on the rank's rows: the
  global batch is cut into ``accum_steps`` microbatches first and each
  microbatch into the data axis's ranks, as the JAX step shards each
  microbatch.  Every kernel sees plain tensors (a DTensor at a kernel's
  entry raises).  The ranks of the other axes compute the same rows.
- The forward runs inside the data axis's scope (``_data_axis``):
  BatchNorm's statistics, a cross-entropy mean over the positions
  ``ignore_index`` keeps, the MoE balancing loss and the Switch capacity
  span the global batch, and a dropout mask is the global batch's mask
  cut to the rank's rows.
- The gradients and the loss are summed over the data axis (one
  collective a dtype) and divided by its size for a mean criterion, so
  every rank holds the global loss and the whole gradients;
  ``grad_transform`` sees those (a global norm is the global norm).
- An elementwise optimizer (``optimizer.elementwise``: SGD, Adam, AdamW,
  Lion, RMSprop, Adagrad, Adadelta) updates each rank's block of each
  parameter with its block of the gradient and its slots; a replicated
  parameter with data-sharded slots (ZeRO-1) is gathered whole after.
  Any other (Muon's Newton-Schulz, Adafactor's factored statistics,
  stochastically rounded Adam, whose bits hang on each element's global
  offset) updates the whole values, gathered, and keeps its block.

So the step computes what the unsharded step computes, and the model's
parameters and slots are stored in blocks.  The gathered copies are live
for the whole step, and the ranks of a model axis repeat one another's
work outside ring attention; splitting the products over that axis is
not done.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import _data_axis
from ..autograd import flag_kept
from ..jit import CompiledEvalStep, CompiledTrainStep, _owners, _traced_routes
from .mesh import (P, PartitionSpec, as_dtensor, axis_size, is_replicated, local_block,
                   placements)


def expert_parallel_rules(axis: str = "model", base: Optional[Callable] = None) -> Callable:
    """EP rule: shard MoE stacked-expert tensors (``experts_*``, leading
    expert dim) over ``axis``; everything else falls through to ``base``
    (or replicated)."""

    def rule(name: str, shape) -> PartitionSpec:
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("experts_") and len(shape) == 3:
            return P(axis, None, None)
        return base(name, shape) if base is not None else P()

    return rule


def fsdp_rules(mesh, axis: str = "data", min_elems: int = 2048,
               base: Optional[Callable] = None) -> Callable:
    """ZeRO-3 / FSDP rule: shard every parameter of at least ``min_elems``
    elements over ``axis`` on its first dimension divisible by the axis's
    size; smaller ones stay replicated.  A parameter that ``base`` shards
    keeps ``base``'s layout, so ``fsdp_rules(mesh,
    base=tensor_parallel_rules())`` gives TP weights and FSDP for the rest."""
    d = axis_size(mesh, axis)

    def rule(name: str, shape) -> PartitionSpec:
        if base is not None:
            spec = base(name, shape)
            if spec != P():
                return spec
        n = 1
        for s in shape:
            n *= s
        if n >= min_elems:
            for i, s in enumerate(shape):
                if s >= d and s % d == 0:
                    return P(*([None] * i), axis, *([None] * (len(shape) - 1 - i)))
        return P()

    return rule


def tensor_parallel_rules(axis: str = "model", shard_conv: bool = True) -> Callable:
    """Default TP rule: Linear weights ``(in, out)`` and their ``(1, out)``
    biases on the out-features, conv kernels ``(out, in, kh, kw)`` on the
    out-channels; everything else (BN affine vectors, ``(1, C, 1, 1)``
    biases) replicated."""

    def rule(name: str, shape) -> PartitionSpec:
        if len(shape) == 2 and name.endswith("weight"):
            return P(None, axis)
        if len(shape) == 2 and name.endswith("bias"):
            return P(None, axis)
        if shard_conv and len(shape) == 4 and shape[2] > 1 and name.endswith("weight"):
            return P(axis, None, None, None)  # the kh > 1 guard leaves (1, C, 1, 1) out
        if (shard_conv and len(shape) == 4 and name.endswith("weight")
                and shape[0] > 1 and shape[1] > 1):
            return P(axis, None, None, None)  # 1x1 conv
        return P()

    return rule


def _place(params, slots, mesh, specs):
    """Put a DTensor Parameter placed by each spec in every slot of each
    parameter (the value of mesh coordinate 0, as ``distribute_tensor``
    sends it); returns the new parameters and their placements."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    new, pls = [], []
    with torch.no_grad():
        for p, owners, spec in zip(params, slots, specs):
            pl = placements(mesh, spec)
            full = p.full_tensor() if isinstance(p, DTensor) else p.detach()
            q = torch.nn.Parameter(distribute_tensor(full, mesh, pl),
                                   requires_grad=p.requires_grad)
            for module, name in owners:
                module._parameters[name] = q
            new.append(q)
            pls.append(pl)
    return new, pls


def _gather(params):
    """Each parameter's whole value, as a plain tensor."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return [p.full_tensor() if isinstance(p, DTensor) else p.detach() for p in params]


class ShardedTrainStep(CompiledTrainStep):
    def __init__(
        self,
        model,
        optimizer,
        criterion,
        mesh,
        data_axis: str = "data",
        param_rules: Optional[Callable] = None,
        donate: bool = True,
        metrics_fn: Optional[Callable] = None,
        compute_dtype=None,
        grad_transform: Optional[Callable] = None,
        accum_steps: int = 1,
        zero_shard_state: bool = False,
    ):
        """``CompiledTrainStep``'s arguments, and the ``mesh`` (a
        ``DeviceMesh``), the name of its data axis, the placement rule
        and ``zero_shard_state`` (ZeRO-1)."""
        super().__init__(model, optimizer, criterion, donate=donate, metrics_fn=metrics_fn,
                         compute_dtype=compute_dtype, grad_transform=grad_transform,
                         accum_steps=accum_steps)
        self.mesh = mesh
        self.data_axis = data_axis
        if data_axis in mesh.mesh_dim_names:
            self._data = _data_axis.Scope(mesh.get_group(data_axis), axis_size(mesh, data_axis),
                                     mesh.get_local_rank(data_axis))
        else:
            self._data = None  # the batch is not split
        names = [n for n, _ in model.named_parameters()]
        specs = [param_rules(n, p.shape) if param_rules else P()
                 for n, p in zip(names, self._params)]
        old = self._params
        self._params, self._pl = _place(old, self._slots, mesh, specs)
        by_id = {id(p): q for p, q in zip(old, self._params)}
        optimizer.params = [by_id[id(p)] for p in optimizer.params]
        from torch.distributed.tensor import Replicate, distribute_tensor

        rep = (Replicate(),) * mesh.ndim
        with torch.no_grad():  # mesh coordinate 0's buffers on every rank
            for _, b in model.named_buffers():
                b.copy_(distribute_tensor(b, mesh, rep).to_local())
        # the block each optimizer slot holds: its parameter's, or under
        # ZeRO-1 a replicated parameter's dim 0 over the data axis
        self._upl = []
        for i in self._opt_index:
            pl, shape = self._pl[i], self._params[i].shape
            if (zero_shard_state and self._data and is_replicated(pl) and len(shape) >= 1
                    and shape[0] > 1 and shape[0] % self._data.size == 0):
                pl = placements(mesh, P(data_axis))
            self._upl.append(pl)
        with torch.no_grad():
            optimizer._state = _map_slots(optimizer._state, lambda j, x, k: distribute_tensor(
                x, mesh, self._slot_pl(j, x)))
        self._masters = None

    def _slot_pl(self, j, x):
        """A slot shaped like its parameter is placed as the update's block;
        another (Adafactor's factors) is replicated."""
        if tuple(x.shape) == tuple(self.optimizer.params[j].shape):
            return self._upl[j]
        return placements(self.mesh, P())

    def _full_params(self):
        self._masters = _gather(self._params)
        return self._masters

    def _microbatches(self, x, y):
        d = self._data
        for xm, ym in super()._microbatches(x, y):
            if d is None:
                yield xm, ym
                continue
            if xm.shape[0] % d.size:
                raise ValueError(f"a microbatch of {xm.shape[0]} rows does not divide "
                                 f"over the {d.size} ranks of the data axis")
            yield xm.chunk(d.size)[d.rank], ym.chunk(d.size)[d.rank]

    def _scope(self):
        d = self._data
        return contextlib.nullcontext() if d is None else _data_axis.scope(*d)

    def _reduce(self, loss, grads, metrics):
        d = self._data
        if d is None:
            return loss, grads, metrics
        scale = 1.0 if getattr(self.criterion, "reduction", "mean") == "sum" else 1.0 / d.size
        live = [i for i, g in enumerate(grads) if g is not None]
        grads = list(grads)
        with torch.no_grad():
            # the same order on every rank (a set of dtypes iterates by id)
            for dt in sorted({grads[i].dtype for i in live} | {loss.dtype}, key=str):
                idx = [i for i in live if grads[i].dtype == dt]
                parts = [grads[i].reshape(-1) for i in idx]
                if loss.dtype == dt:
                    parts.append(loss.reshape(1))
                flat = torch.cat(parts)
                dist.all_reduce(flat, group=d.group)
                flat.mul_(scale)
                at = 0
                for i in idx:
                    n = grads[i].numel()
                    grads[i] = flat[at:at + n].view(grads[i].shape)
                    at += n
                if loss.dtype == dt:
                    loss = flat[at].clone()
            metrics = _map_leaves(lambda t: _mean_over(t, d), metrics)
        return loss, grads, metrics

    def _update(self, grads, lr):
        opt, mesh, idx, full = self.optimizer, self.mesh, self._opt_index, self._masters
        ew = getattr(opt, "elementwise", False)
        with torch.no_grad():
            if ew:  # each rank its blocks
                params = [self._params[i].to_local() if self._upl[j] == self._pl[i]
                          else local_block(full[i], mesh, self._upl[j])
                          for j, i in enumerate(idx)]
                gs = [None if grads[i] is None
                      else local_block(grads[i], mesh, self._upl[j]).contiguous()
                      for j, i in enumerate(idx)]
                state = _map_slots(opt._state, lambda j, x, k: x.to_local())
            else:  # the whole values
                params = [full[i] for i in idx]
                gs = [grads[i] for i in idx]
                state = _map_slots(opt._state, lambda j, x, k: x.full_tensor())
            new_params, new_state = opt.pure_update(params, gs, state, lr)
            for j, (i, new) in enumerate(zip(idx, new_params)):
                if not ew:
                    new = local_block(new, mesh, self._pl[i])
                elif self._upl[j] != self._pl[i]:
                    new = _gather_dim0(new, self._data)  # ZeRO-1: whole again
                mine = self._params[i].to_local()
                if new.data_ptr() != mine.data_ptr():
                    mine.copy_(new)
            if ew:  # a block updated in place keeps its DTensor
                old = opt._state
                opt._state = _map_slots(new_state, lambda j, x, k: old[k][j]
                                        if x.data_ptr() == old[k][j].to_local().data_ptr()
                                        else as_dtensor(x, mesh, self._upl[j],
                                                        opt.params[j].shape))
            else:
                opt._state = _map_slots(new_state, lambda j, x, k: as_dtensor(
                    local_block(x, mesh, self._slot_pl(j, x)).contiguous(), mesh,
                    self._slot_pl(j, x), x.shape))
        self._masters = None


def _gather_dim0(block, d):
    parts = [torch.empty_like(block) for _ in range(d.size)]
    dist.all_gather(parts, block.contiguous(), group=d.group)
    return torch.cat(parts, 0)


def _mean_over(t, d):
    t = t.detach().clone()
    dist.all_reduce(t, group=d.group)
    return t / d.size


def _map_leaves(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _map_slots(state, fn):
    """``fn(j, slot, key)`` over the per-parameter slots of an optimizer
    state; counters and None entries kept."""
    return {k: [None if x is None else fn(j, x, k) for j, x in enumerate(v)]
            if isinstance(v, list) else v for k, v in state.items()}


class ShardedEvalStep(CompiledEvalStep):
    """Inference over a mesh: with ``param_rules`` the parameters are
    placed by them (without, they stay as they are, plain or DTensor),
    and gathered whole for the call; each rank runs the forward on its
    rows of the data axis and the outputs are gathered, so every rank
    returns the global batch's output."""

    def __init__(self, model, mesh, data_axis: str = "data", param_rules=None):
        super().__init__(model)
        self.mesh = mesh
        params = [p for _, p in model.named_parameters()]
        if param_rules is not None:
            specs = [param_rules(n, p.shape) for (n, _), p in zip(model.named_parameters(),
                                                                   params)]
            params, _ = _place(params, _owners(model, params), mesh, specs)
        self._params = params
        self._slots = _owners(model, params)
        self._data = None
        if data_axis in mesh.mesh_dim_names:
            self._data = _data_axis.Scope(mesh.get_group(data_axis), axis_size(mesh, data_axis),
                                     mesh.get_local_rank(data_axis))

    def __call__(self, x):
        dev = self._params[0].device
        x = torch.as_tensor(x, device=dev)
        d = self._data
        if d is not None:
            if x.shape[0] % d.size:
                raise ValueError(f"batch of {x.shape[0]} rows does not divide over the "
                                 f"{d.size} ranks of the data axis")
            x = x.chunk(d.size)[d.rank]
        full = _gather(self._params)
        for slots, t in zip(self._slots, full):
            for module, name in slots:
                module._parameters[name] = t
        was_training = self.model.training
        with flag_kept():  # eval() and train() set the tape's grad flag
            self.model.eval()
            try:
                with torch.no_grad(), _traced_routes():
                    out = self.model(x)
            finally:
                for slots, p in zip(self._slots, self._params):
                    for module, name in slots:
                        module._parameters[name] = p
                if was_training:
                    self.model.train()
        return out if d is None else _gather_dim0(out, d)
