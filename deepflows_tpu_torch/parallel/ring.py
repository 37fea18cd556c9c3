"""Ring attention: sequence parallelism in which the sequence never
gathers for the scores (counterpart of ``deepflows_tpu/parallel/ring.py``).

Each rank of the mesh axis ``axis`` holds one chunk of L / P positions of
Q, K and V.  In each of P steps it attends its query chunk to the K/V chunk
it holds and passes K/V one hop around the ring (point-to-point over the
axis's group: send to rank i + 1, receive from i - 1).  The arithmetic is
the JAX package's: f32 scores, ``-1e30`` masking, causal blocks above the
diagonal predicated and not skipped, the running ``(m, l, acc)`` merge
with the ``l == 0`` guard, and the output cast to q's dtype.  So the
largest block a rank holds is ``(B, H, L/P, L/P)`` in f32.

JAX differentiates the ring through ``ppermute``'s transpose; here the
backward is written out (``_Ring``): it recomputes each step's
probabilities from the forward's log-sum-exp and sends the K/V chunk
around again with its dK/dV accumulators, which come home after P hops.

``ring_attention`` takes plain tensors that every rank of the axis holds
whole, as inside ``ShardedTrainStep``, which hands the model plain
tensors: each rank takes its chunk, and the output and the gradients are
gathered whole again over the axis.  A DTensor is refused.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import axis_size

NEG = -1e30


def _rotate(group, tensors):
    """Send each tensor to the next rank of the ring, receive the previous
    rank's: one hop (on a ring of one rank, to itself: the tensors)."""
    me = dist.get_rank(group)
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return out


def _scores(qf, k, scale, causal, idx, src, lc):
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale  # (B, H, Lc, Lc)
    if causal:
        pos = torch.arange(lc, device=qf.device)
        hide = (src * lc + pos)[None, :] > (idx * lc + pos)[:, None]
        s = torch.where(hide, torch.full((), NEG, device=s.device), s)
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, causal):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        lc = q.shape[2]
        qf = q.float()
        m = torch.full(q.shape[:3] + (1,), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for s in range(n):
            sc = _scores(qf, kc, scale, causal, idx, (idx - s) % n, lc)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vc.float())
            m = m_new
            if s < n - 1:
                kc, vc = _rotate(group, [kc, vc])
        l_safe = torch.where(l == 0.0, torch.ones((), device=l.device), l)
        out = acc / l_safe
        ctx.save_for_backward(q, k, v, out, m + torch.log(l_safe))
        ctx.group, ctx.scale, ctx.causal = group, scale, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale, causal = ctx.group, ctx.scale, ctx.causal
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        lc = q.shape[2]
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for s in range(n):
            sc = _scores(qf, kc, scale, causal, idx, (idx - s) % n, lc)
            p = torch.exp(sc - lse)
            dv = dv + torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, vc.float().transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, kc.float()) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), qf) * scale
            # the chunk and its gradients travel together; after n hops
            # the gradients are home
            if s < n - 1:
                kc, vc, dk, dv = _rotate(group, [kc, vc, dk, dv])
            else:
                dk, dv = _rotate(group, [dk, dv])
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


class _Chunk(torch.autograd.Function):
    """This rank's chunk of a tensor every rank of ``group`` holds whole;
    the gradient is gathered whole again."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        return x.chunk(n, dim)[dist.get_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """The chunks of ``group`` concatenated along ``dim``; the gradient
    (whole and the same on every rank) is cut back to this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)].contiguous(), None, None


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def ring_attention(q, k, v, mesh, axis: str = "model", *, causal: bool = False,
                   sm_scale: Optional[float] = None, batch_axis: Optional[str] = "data"):
    """softmax(Q Kᵀ · scale [+ causal]) V for (B, H, L, D) Q, K, V with L
    split over the mesh axis ``axis`` (L must divide by its size).
    ``batch_axis`` is the JAX package's argument: each rank here holds its
    rows of that axis already."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r}")
    n = axis_size(mesh, axis)
    d, length = q.shape[-1], q.shape[2]
    if length % n:
        raise ValueError(f"sequence length {length} not divisible by {n}")
    scale = (1.0 / math.sqrt(d)) if sm_scale is None else float(sm_scale)
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("ring_attention takes the plain tensors each rank of the axis "
                        "holds whole (as inside ShardedTrainStep), not DTensors")
    group = mesh.get_group(axis)
    q, k, v = (_Chunk.apply(t, group, 2) for t in (q, k, v))
    return _Gather.apply(_Ring.apply(q, k, v, group, scale, causal), group, 2)
