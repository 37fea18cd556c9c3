"""Pipeline parallelism over a ``pipe`` mesh axis (counterpart of
``deepflows_tpu/parallel/pipeline.py``): ``PipelineStack``,
``pipeline_apply`` and ``PipelinedTrainStep`` with the GPipe, 1F1B and
interleaved 1F1B schedules.

The JAX package writes the pipeline as one SPMD program: a ``lax.scan``
over ticks whose activation buffer moves one stage on by ``jnp.roll`` on
the pipe-sharded axis, differentiated by ``jax.grad`` (GPipe) or by a
hand-rolled per-stage ``jax.vjp`` (1F1B, interleaved).  Here each rank is
a process, and the schedules are spelt out on ``torch.distributed``:

- A ``PipelineStack`` holds ``S`` homogeneous stages with their parameters
  and buffers stacked on a leading stage axis, in the JAX package's
  state_dict layout (``stacked_{i}_{name}``, shape ``(S, ...)``).  A
  ``PipelinedTrainStep`` stores them, and the optimizer's slots, as DTensor
  blocks ``Shard(0)`` over the pipe axis (plus whatever ``param_rules``
  adds inside a stage); pre and post parameters are replicated.
- A step is a grid of ticks that every rank knows whole.  At each tick a
  rank runs the forward (F) and the backward (B) of the (chunk, microbatch)
  pairs the schedule gives it, then the tick's activations go one chunk on
  and its input gradients one chunk back, by ``dist.batch_isend_irecv`` on
  the pipe axis's group (NCCL on cards, gloo on the CPU); a message
  between chunks on the same rank stays local.  The grids are the JAX
  package's: GPipe's ``M + S - 1`` forward ticks, the head, then as many
  backward ticks; 1F1B's ``M + 2(S - 1)`` ticks, stage ``s`` forwarding
  microbatch ``t - s`` and backwarding ``t - 2S + 2 + s``; interleaved
  1F1B's slices, chunk ``c = jP + d`` of microbatch ``m = gP + r`` forward
  at ``c + r + gC`` and backward at ``2(C - 1) - c + r + gC``
  (``fwd_decode`` and ``bwd_decode``).
- A rank skips what the JAX program computes on bubble ticks and then
  discards, so no stage ever runs on filler data.
- Each in-flight microbatch keeps its autograd graph from its forward to
  its backward (the JAX package stashes stage inputs and recomputes under
  ``jax.vjp``, since a scan cannot carry closures).  So a stage's forward
  runs once a microbatch, and the activations a rank holds are those of
  the microbatches in flight on it: all ``M`` under GPipe, at most
  ``2S - 1`` under 1F1B and ``2Pv`` chunk inputs under interleaved 1F1B,
  whatever ``M``.
- The first pipe rank runs ``pre``, the last ``post`` and the criterion.
  Gradients accumulate in the masters' dtype; pre and post gradients and
  the loss are summed over the pipe axis, then everything over the data
  axis as ``ShardedTrainStep._reduce`` does, so every rank returns the
  global loss and holds the same pre and post values.  Stages and the
  criterion run inside the data axis's scope (``_data_axis``), so
  BatchNorm takes the statistics of the global microbatch.

Dropout in a stage is refused in training: the JAX package's masks there
are trace constants, which the port does not copy.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _data_axis
from ..jit import _owners, _traced_routes
from ..nn.modules.dropout import Dropout
from ..nn.modules.module import Module
from ..purify import call_by_names, purified_call, purify_fn  # noqa: F401  (re-export)
from .mesh import P, as_dtensor, axis_size, local_block, placements
from .sharded import _map_slots


# --------------------------------------------------------------------------
# purification: modules -> functions of the tensors standing for parameters
# --------------------------------------------------------------------------
def _refuse_live_dropout(module, role: str, training: Optional[bool] = None) -> None:
    """A Dropout with p > 0 that would run in training mode (``training``
    None: the module's own mode) is refused."""
    live = [n or type(module).__name__ for n, m in module.named_modules()
            if isinstance(m, Dropout) and m.p > 0
            and (m.training if training is None else training)]
    if live:
        raise ValueError(
            f"{role} hold a live Dropout ({', '.join(live)}): the pipeline does not "
            "support dropout in training (the JAX package's mask there is a trace "
            "constant); use p=0 or eval mode"
        )


def purify_module(module: Module, role: str = "pipeline stages") -> Callable:
    """``fn(param_tensors, x) -> y``: the module's forward with the given
    tensors in place of its parameters, in ``named_parameters()`` order
    (``purified_call``).  The module must
    be buffer-free and hold no live Dropout."""
    names = [n for n, _ in module.named_parameters()]
    if any(True for _ in module.named_buffers()):
        raise ValueError(
            f"{role} must be buffer-free (BatchNorm running stats "
            "cannot be threaded through the pipeline scan); use GroupNorm-"
            "style normalisation or norm-free stages"
        )
    _refuse_live_dropout(module, role)

    def fn(param_tensors, x):
        y, _ = call_by_names(module, names, [], param_tensors, [], x)
        return y

    return fn


# --------------------------------------------------------------------------
# the stacked-stage container
# --------------------------------------------------------------------------
class PipelineStack(Module):
    """``S`` homogeneous stage modules with parameters (and buffers) stacked
    on a leading stage axis, registered as this module's own
    (``stacked_{i}_{name with . -> _}``), so ``.parameters()`` feeds any
    optimizer and ``state_dict`` is the JAX package's.  ``stages[0]`` is
    kept, unregistered, as the ``template`` whose forward runs every stage
    with that stage's tensors bound in.

    Stages must agree in parameter and buffer names and shapes and in their
    ``repr`` (types and configuration: BatchNorm's momentum, an
    activation's slope), since stage 0's forward serves all of them."""

    def __init__(self, stages: Sequence[Module]):
        super().__init__()
        stages = list(stages)
        if len(stages) < 1:
            raise ValueError("need at least one stage")

        def _structure(s):
            return (
                [(n, tuple(p.shape)) for n, p in s.named_parameters()],
                [(n, tuple(b.shape)) for n, b in s.named_buffers()],
                repr(s),
            )

        struct0 = _structure(stages[0])
        for s in stages[1:]:
            if _structure(s) != struct0:
                raise ValueError(
                    "pipeline stages must be homogeneous (identical module/"
                    f"parameter/buffer structure — stage 0's forward runs "
                    f"every stage); got {_structure(s)} vs {struct0}"
                )
        self.n_stages = len(stages)
        # not a registered submodule: its own (stage 0's) parameters must not
        # appear in .parameters() beside the stacked ones
        object.__setattr__(self, "template", stages[0])
        self._param_names = [n for n, _ in stages[0].named_parameters()]
        self._buffer_names = [n for n, _ in stages[0].named_buffers()]
        per_stage_params = [[p for _, p in s.named_parameters()] for s in stages]
        per_stage_bufs = [[b for _, b in s.named_buffers()] for s in stages]
        with torch.no_grad():
            for i, name in enumerate(self._param_names):
                # the index prefix keeps flattened names apart ('conv_1.w'
                # and 'conv.1.w' flatten alike)
                first = per_stage_params[0][i]
                self.register_parameter(
                    f"stacked_{i}_{name.replace('.', '_')}",
                    torch.nn.Parameter(torch.stack([ps[i].detach() for ps in per_stage_params]),
                                       requires_grad=first.requires_grad),
                )
            for i, name in enumerate(self._buffer_names):
                self.register_buffer(
                    f"stacked_{i}_{name.replace('.', '_')}",
                    torch.stack([bs[i].detach() for bs in per_stage_bufs]),
                )

    def stage_fn(self) -> Callable:
        """``fn(param_tensors, x) -> y`` for one stage (buffer-free stages;
        the template's own mode)."""
        return purify_module(self.template)

    def buffered_stage_fn(self, training: bool = True) -> Callable:
        """``fn(param_tensors, buffer_tensors, x) -> (y, new_buffers)`` for
        one stage, run in training mode (batch statistics, the EMA in the
        returned buffers) or eval mode (running statistics); the template's
        mode is flipped for the call only."""
        template = self.template
        names = [n for n, _ in template.named_parameters()]
        bnames = [n for n, _ in template.named_buffers()]
        if training:
            _refuse_live_dropout(template, "pipeline stages", training=True)

        def fn(param_tensors, buffer_tensors, x):
            was = template.training
            template.train(training)
            try:
                return call_by_names(template, names, bnames, param_tensors,
                                     buffer_tensors, x)
            finally:
                template.train(was)

        return fn

    def forward(self, x):
        raise NotImplementedError(
            "PipelineStack is driven by PipelinedTrainStep / its eval_logits "
            "(the pipelined program is array-level, not a tape forward)"
        )


# --------------------------------------------------------------------------
# the grids
# --------------------------------------------------------------------------
def fwd_decode(t: int, d: int, C: int, n_pipe: int, M: int):
    """Interleaved 1F1B: the local chunk ``j``, the microbatch ``m`` and
    whether rank ``d`` runs a forward at slice ``t`` (the JAX package's
    map: chunk ``jP + d`` of microbatch ``gP + r`` at ``c + r + gC``)."""
    delta = t - d
    dc = delta % C
    j, r, g = dc // n_pipe, dc % n_pipe, delta // C
    m = g * n_pipe + r
    return j, m, delta >= 0 and 0 <= m < M


def bwd_decode(t: int, d: int, C: int, n_pipe: int, M: int):
    """Interleaved 1F1B: the local chunk, the microbatch and whether rank
    ``d`` runs a backward at slice ``t`` (at ``2(C - 1) - c + r + gC``)."""
    v = C // n_pipe
    e = t - 2 * (C - 1) + d
    xx = e % C
    r, k = xx % n_pipe, xx // n_pipe
    j = (v - k) % v
    g = (e - r + j * n_pipe) // C
    m = g * n_pipe + r
    return j, m, g >= 0 and m < M


def _gpipe_grid(C, M, owner):
    """GPipe: forward ticks (chunk c of microbatch t - c), then backward
    ticks (chunk c of microbatch u - (C - 1 - c)); the head between them."""
    fwd = [[(owner(c), "F", c, t - c) for c in range(C) if 0 <= t - c < M]
           for t in range(M + C - 1)]
    bwd = [[(owner(c), "B", c, u - (C - 1 - c)) for c in range(C)
            if 0 <= u - (C - 1 - c) < M] for u in range(M + C - 1)]
    return fwd, bwd


def _interleaved_grid(C, n_pipe, M):
    """1F1B (one chunk a rank) and interleaved 1F1B: warmup slices [0, C-1)
    forward only, steady [C-1, F) forward and backward, drain [F, F+C-1)
    backward only."""
    q_last = (M - 1) % n_pipe + C * ((M - 1) // n_pipe)
    f_end = C + q_last
    ticks = []
    for t in range(f_end + C - 1):
        acts = []
        for d in range(n_pipe):
            if t < f_end:
                j, m, ok = fwd_decode(t, d, C, n_pipe, M)
                if ok:
                    acts.append((d, "F", j * n_pipe + d, m))
            if t >= C - 1:
                j, m, ok = bwd_decode(t, d, C, n_pipe, M)
                if ok:
                    acts.append((d, "B", j * n_pipe + d, m))
        ticks.append(acts)
    return ticks


class _Pipe:
    """The pipe axis as this rank sees it: its size, this rank's place, the
    axis's group and its members' global ranks.  Every rank of the group
    makes one (a collective): NCCL needs every rank of a group in its first
    call there, and a tick's messages involve only some."""

    def __init__(self, mesh, pipe_axis):
        self.size = axis_size(mesh, pipe_axis)
        self.rank = mesh.get_local_rank(pipe_axis)
        self.group = mesh.get_group(pipe_axis)
        self.peers = [dist.get_global_rank(self.group, k) for k in range(self.size)]
        if self.size > 1:
            dist.barrier(group=self.group)


def _data_scope(mesh, data_axis):
    if data_axis in mesh.mesh_dim_names and axis_size(mesh, data_axis) > 1:
        return _data_axis.Scope(mesh.get_group(data_axis), axis_size(mesh, data_axis),
                                mesh.get_local_rank(data_axis))
    return None


def _run_grid(ticks, C, pipe, owner, fwd, bwd, like):
    """Run this rank's part of ``ticks``: ``fwd(c, m, x) -> y`` and ``bwd(c,
    m, dy) -> dx`` (``x`` and ``dy`` None where the rank makes them itself),
    then each tick's messages in one ``batch_isend_irecv``: an F's output to
    chunk c + 1's owner, a B's input gradient to chunk c - 1's owner.
    Every rank lists the tick's messages in the same order, so each pair's
    sends and receives match.  ``like()`` is an empty message buffer."""
    me = pipe.rank
    inbox, outbox = {}, {}
    for acts in ticks:
        for r, kind, c, m in acts:
            if r != me:
                continue
            if kind == "F":
                y = fwd(c, m, inbox.pop(("F", c, m), None))
                if c + 1 < C:
                    outbox[("F", c + 1, m)] = y
            else:
                dx = bwd(c, m, inbox.pop(("B", c, m), None))
                if c > 0:
                    outbox[("B", c - 1, m)] = dx
        ops = []
        for r, kind, c, m in acts:
            key = ("F", c + 1, m) if kind == "F" else ("B", c - 1, m)
            if not 0 <= key[1] < C:
                continue
            dst = owner(key[1])
            if r == dst == me:
                inbox[key] = outbox.pop(key)
            elif r == me:
                ops.append(dist.P2POp(dist.isend, outbox.pop(key).contiguous(),
                                      pipe.peers[dst], pipe.group))
            elif dst == me:
                inbox[key] = like()
                ops.append(dist.P2POp(dist.irecv, inbox[key], pipe.peers[r], pipe.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    assert not inbox and not outbox, "pipeline grid left messages unconsumed"


def _rows_of(t, mesh, pipe_axis):
    """This rank's rows of a stacked tensor, whole over every other mesh
    axis: a DTensor's block gathered over the others, or a plain tensor's
    ``torch.chunk`` over the pipe axis."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    k = mesh.mesh_dim_names.index(pipe_axis)
    if not isinstance(t, DTensor):
        return t.chunk(mesh.size(k))[mesh.get_local_rank(k)]
    if all(p.is_replicate() for i, p in enumerate(t.placements) if i != k):
        return t.to_local()
    pl = tuple(Shard(0) if i == k else Replicate() for i in range(mesh.ndim))
    return t.redistribute(mesh, pl).to_local()


def _bcast(t, src, group, device):
    """``t`` (on rank ``src`` of ``group``; None elsewhere) on every rank:
    its shape and dtype first, then its values."""
    codes = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
             torch.int32]
    head = torch.zeros(10, dtype=torch.int64, device=device)
    if dist.get_rank(group) == src:
        head[0], head[1] = t.dim(), codes.index(t.dtype)
        head[2:2 + t.dim()] = torch.tensor(t.shape)
    dist.broadcast(head, dist.get_global_rank(group, src), group)
    if dist.get_rank(group) != src:
        n = int(head[0])
        t = torch.empty(tuple(int(s) for s in head[2:2 + n]), dtype=codes[int(head[1])],
                        device=device)
    dist.broadcast(t.contiguous(), dist.get_global_rank(group, src), group)
    return t


def _gather_rows(rows, data, M):
    """The global batch from each data rank's rows of every microbatch
    (``rows`` microbatch-major)."""
    if data is None:
        return rows
    parts = [torch.empty_like(rows) for _ in range(data.size)]
    dist.all_gather(parts, rows.contiguous(), group=data.group)
    per = [p.chunk(M) for p in parts]
    return torch.cat([per[r][m] for m in range(M) for r in range(data.size)])


# --------------------------------------------------------------------------
# the pipelined forward
# --------------------------------------------------------------------------
def pipeline_apply(
    stage_fn: Callable,
    stacked_params,
    x_micro,
    *,
    stacked_buffers=None,
    mesh=None,
    pipe_axis: str = "pipe",
    data_axis: str = "data",
):
    """Run ``M`` microbatches through ``S`` stages; returns the outputs
    ``(M, b, ...)``, or ``(outs, final_buffers)`` with ``stacked_buffers``
    (``stage_fn(params, buffers, x) -> (y, new_buffers)``, as
    ``PipelineStack.buffered_stage_fn`` gives).

    Tick ``t`` runs stage ``s`` on microbatch ``t - s`` where that is a
    microbatch, so the outputs are the stages run one after another, and a
    stage's buffers (BatchNorm's EMA) advance once for each microbatch it
    runs.  A stage whose output's shape or dtype is not its input's raises
    ``ValueError`` on its first call, before its output goes on.

    Without a mesh this runs in this process, differentiably.  With one,
    each rank of the pipe axis runs its contiguous block of stages (from a
    whole stacked tensor or a pipe-sharded DTensor) on its rows of each
    microbatch over the data axis, the activations move by point-to-point
    messages, and every rank returns the whole outputs (and buffers); no
    gradient crosses ranks."""
    buffered = stacked_buffers is not None
    M = x_micro.shape[0]
    if M < 1:
        raise ValueError("need at least one microbatch")
    if mesh is not None:
        return _pipeline_apply_mesh(stage_fn, stacked_params, x_micro, stacked_buffers, mesh,
                                    pipe_axis, data_axis)
    S = stacked_params[0].shape[0]
    bufs = [list(b.unbind(0)) for b in stacked_buffers] if buffered else []
    state = [None] * S  # the activation entering each stage
    outs = [None] * M
    for t in range(M + S - 1):
        nxt = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            x = x_micro[m] if s == 0 else state[s]
            if buffered:
                y, nb = stage_fn([a[s] for a in stacked_params], [b[s] for b in bufs], x)
                for b, new in zip(bufs, nb):
                    b[s] = new
            else:
                y = stage_fn([a[s] for a in stacked_params], x)
            _check_shape(y, x)
            if s + 1 < S:
                nxt[s + 1] = y
            else:
                outs[m] = y
        state = nxt
    out = torch.stack(outs)
    return (out, [torch.stack(b) for b in bufs]) if buffered else out


def _check_shape(y, x):
    if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype:
        raise ValueError(
            f"stage output shape {tuple(y.shape)} ({y.dtype}) != input shape "
            f"{tuple(x.shape)} ({x.dtype}); pipeline stages must preserve activation shape"
        )


def _pipeline_apply_mesh(stage_fn, stacked_params, x_micro, stacked_buffers, mesh, pipe_axis,
                         data_axis):
    buffered = stacked_buffers is not None
    pipe = _Pipe(mesh, pipe_axis)
    data = _data_scope(mesh, data_axis)
    S, M = stacked_params[0].shape[0], x_micro.shape[0]
    if S % pipe.size:
        raise ValueError(f"{S} stages do not divide over mesh {pipe_axis}={pipe.size}")
    v = S // pipe.size
    rows = [_rows_of(a, mesh, pipe_axis) for a in stacked_params]
    brows = [_rows_of(b, mesh, pipe_axis).clone() for b in stacked_buffers or []]
    xs = [x_micro[m] if data is None else x_micro[m].chunk(data.size)[data.rank]
          for m in range(M)]
    outs = {}

    def scope():
        return contextlib.nullcontext() if data is None else _data_axis.scope(*data)

    def fwd(c, m, x):
        j = c % v
        x = xs[m] if c == 0 else x
        with scope():
            if buffered:
                y, nb = stage_fn([a[j] for a in rows], [b[j] for b in brows], x)
                for b, new in zip(brows, nb):
                    b[j].copy_(new)
            else:
                y = stage_fn([a[j] for a in rows], x)
        _check_shape(y, x)
        if c == S - 1:
            outs[m] = y
        return y.detach()

    fgrid, _ = _gpipe_grid(S, M, lambda c: c // v)
    _run_grid(fgrid, S, pipe, lambda c: c // v, fwd, None,
              lambda: torch.empty_like(xs[0]))
    last = pipe.size - 1
    mine = torch.cat([outs[m] for m in range(M)]) if pipe.rank == last else None
    if mine is not None:  # the last rank's data group: every rank of it is last
        mine = _gather_rows(mine, data, M)
    out = _bcast(mine, last, pipe.group, x_micro.device)
    out = out.reshape((M, -1) + tuple(out.shape[1:]))
    if not buffered:
        return out
    new_bufs = []
    for b in brows:
        parts = [torch.empty_like(b) for _ in range(pipe.size)]
        dist.all_gather(parts, b.contiguous(), group=pipe.group)
        new_bufs.append(torch.cat(parts))
    return out, new_bufs


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
class PipelinedTrainStep:
    """One training step over a mesh with a pipe axis: the microbatched
    pipeline forward and backward of the chosen schedule, the reductions,
    and the optimizer's ``pure_update`` on each rank's blocks.

    ``optimizer`` must hold exactly ``pre.parameters() + stack.parameters()
    + post.parameters()`` (pre and post optional, buffer-free).
    ``criterion(output, y)`` is a loss module or function; ``metrics_fn``
    is not supported (use :meth:`eval_logits`).  ``pre`` maps the raw input
    (tokens) to the blocks' activation and runs on the first pipe rank;
    ``post`` maps the last block's activation to the output (logits) and
    runs with the criterion on the last.  Every rank calls the step with
    the whole global batch and returns the global loss (f32 under a
    ``compute_dtype``)."""

    def __init__(
        self,
        stack: PipelineStack,
        optimizer,
        criterion: Callable,
        mesh,
        n_micro: int,
        *,
        pre: Optional[Module] = None,
        post: Optional[Module] = None,
        data_axis: str = "data",
        pipe_axis: str = "pipe",
        donate: bool = True,
        grad_transform: Optional[Callable] = None,
        compute_dtype=None,
        param_rules: Optional[Callable] = None,
        schedule: str = "gpipe",
    ):
        """``mesh`` is a ``DeviceMesh`` (``parallel.make_mesh``) with the pipe
        axis, over every rank of the default group.  ``donate`` is accepted
        for the JAX package's signature; the update reuses the blocks'
        memory where the optimizer works in place.

        ``compute_dtype=torch.bfloat16`` runs forward and backward on bf16
        copies; the f32 masters, the gradients the optimizer sees and its
        slots stay f32, and buffers keep their dtype.

        ``param_rules(name, per_stage_shape) -> PartitionSpec`` places each
        stage's parameters over other mesh axes (tensor parallelism inside
        a stage); the pipe axis is prefixed on the stacked leading dim, so
        ``tensor_parallel_rules("model")`` gives a Linear weight
        ``P("pipe", None, "model")``.  The ranks of such an axis compute the
        stage whole on gathered values, as ``ShardedTrainStep`` does, and
        update their blocks.

        ``grad_transform`` sees the global gradients in parameter order
        (every stage's rows, gathered): a global-norm clip takes in every
        stage.

        ``schedule``:

        - ``"gpipe"``: every forward, the criterion on the whole batch, then
          every backward; a rank holds all ``M`` microbatches' activations.
          Bubble ``(S-1)/(M+S-1)``.
        - ``"1f1b"``: warmup forward ticks, one-forward-one-backward ticks,
          drain backward ticks; the loss of each microbatch, scaled by
          ``1/M``, and the head's backward run in the tick where the last
          stage finishes it, so a rank holds at most ``2S - 1`` microbatches
          in flight whatever ``M``.  The same bubble as GPipe.
        - ``"interleaved_1f1b"``: the ``S`` stages become ``C = S`` chunks
          laid round-robin over the ``P`` pipe ranks (chunk ``c`` on rank
          ``c mod P``, ``v = S/P`` a rank; ``S % P == 0``), one chunk a
          rank a slice.  Bubble ``(P-1)/(vM + P-1)`` for ``M`` a multiple
          of ``P``.  The stacked parameters, buffers and slots are stored
          PERMUTED at construction (physical row ``q`` holds logical chunk
          ``(q % v)·P + q // v``, so each rank's ``Shard(0)`` block is its
          chunk set); ``self._stage_perm`` is that permutation and
          ``eval_logits`` walks chunks in logical order.  A state_dict saved
          from such a run holds the permuted stacking.  A later step over
          the same stack composes with the stored order
          (``stack._stage_layout_perm``), and a non-interleaved one restores
          logical order.
        """
        if schedule not in ("gpipe", "1f1b", "interleaved_1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.schedule = schedule
        if pipe_axis not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {pipe_axis!r}")
        n_pipe = axis_size(mesh, pipe_axis)
        if schedule == "interleaved_1f1b":
            if stack.n_stages % n_pipe:
                raise ValueError(
                    f"interleaved_1f1b needs n_stages ({stack.n_stages}) "
                    f"divisible by mesh {pipe_axis}={n_pipe}"
                )
            self.virtual_stages = stack.n_stages // n_pipe
        elif n_pipe != stack.n_stages:
            raise ValueError(f"mesh {pipe_axis}={n_pipe} != {stack.n_stages} stages")
        self.stack = stack
        self.optimizer = optimizer
        self.criterion = criterion
        self.mesh = mesh
        self.n_micro = int(n_micro)
        self.data_axis = data_axis
        self.pipe_axis = pipe_axis
        self.grad_transform = grad_transform
        self.compute_dtype = compute_dtype
        self.pre = pre
        self.post = post
        pre_params = [p for _, p in pre.named_parameters()] if pre else []
        post_params = [p for _, p in post.named_parameters()] if post else []
        stack_params = [p for _, p in stack.named_parameters()]
        self._n_pre = len(pre_params)
        self._n_post = len(post_params)
        self._params = pre_params + stack_params + post_params
        self._pre_fn = purify_module(pre, "pre stages") if pre else None
        self._post_fn = purify_module(post, "post stages") if post else None
        if [id(p) for p in optimizer.params] != [id(p) for p in self._params]:
            raise ValueError(
                "optimizer must hold exactly pre.parameters() + "
                "stack.parameters() + post.parameters()"
            )
        optimizer._ensure_state()
        self._buffered = any(True for _ in stack.named_buffers())
        if self._buffered:
            self._stage_fn = stack.buffered_stage_fn(training=True)
            self._eval_stage_fn = stack.buffered_stage_fn(training=False)
        else:
            self._stage_fn = stack.stage_fn()
            self._eval_stage_fn = self._stage_fn
        self._criterion = purify_fn(criterion)
        self._pipe = _Pipe(mesh, pipe_axis)
        self._data = _data_scope(mesh, data_axis)
        self._v = stack.n_stages // n_pipe
        self._place(stack, optimizer, pre, post, stack_params, param_rules, n_pipe)
        self._grids = {}
        self._act_meta = {}

    # ------------------------------------------------------------------
    def _place(self, stack, optimizer, pre, post, stack_params, param_rules, n_pipe):
        """Permute the stacked rows for the schedule's layout and store every
        parameter, buffer and slot as a DTensor on the mesh."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        mesh, pipe_axis, S = self.mesh, self.pipe_axis, stack.n_stages

        def whole(t):
            return t.full_tensor() if isinstance(t, DTensor) else t.detach()

        specs = []
        for name, p in zip(stack._param_names, stack_params):
            inner = tuple(param_rules(name, tuple(p.shape[1:]))) if param_rules else ()
            if len(inner) > p.dim() - 1:
                raise ValueError(
                    f"param_rules returned a rank-{len(inner)} spec for "
                    f"{name!r} — rules receive the PER-STAGE shape "
                    f"{tuple(p.shape[1:])} (the stacked leading 'pipe' dim is "
                    "added automatically)"
                )
            specs.append(P(pipe_axis, *inner, *([None] * (p.dim() - 1 - len(inner)))))
        self._pl = ([placements(mesh, P())] * self._n_pre + [placements(mesh, s) for s in specs]
                    + [placements(mesh, P())] * self._n_post)
        s0, s1 = self._n_pre, self._n_pre + len(stack_params)
        with torch.no_grad():
            values = [whole(p) for p in self._params]
            bnames = [n for n, _ in stack.named_buffers()]
            bvalues = [whole(b) for _, b in stack.named_buffers()]
            state = {k: [None if x is None else whole(x) for x in v] if isinstance(v, list)
                     else v for k, v in optimizer._state.items()}

            def permute(idx):
                idx = torch.as_tensor(np.asarray(idx), dtype=torch.long)
                for i in range(s0, s1):
                    values[i] = values[i][idx.to(values[i].device)]
                for i, b in enumerate(bvalues):
                    bvalues[i] = b[idx.to(b.device)]
                for slots in state.values():
                    if not isinstance(slots, list):
                        continue  # the step counter is global
                    for i in range(s0, s1):
                        a = slots[i]
                        if a is not None and a.dim() >= 1 and a.shape[0] == S:
                            slots[i] = a[idx.to(a.device)]

            self._stage_perm = self._stage_inv = None
            prev = getattr(stack, "_stage_layout_perm", None)
            ident = np.arange(S)
            if self.schedule == "interleaved_1f1b":
                v = self.virtual_stages
                perm = np.array([(q % v) * n_pipe + q // v for q in range(S)])
                self._stage_perm, self._stage_inv = perm, np.argsort(perm)
                eff = perm if prev is None else np.argsort(np.asarray(prev))[perm]
                if not np.array_equal(eff, ident):
                    permute(eff)
                stack._stage_layout_perm = perm
            elif prev is not None:
                permute(np.argsort(np.asarray(prev)))
                stack._stage_layout_perm = None

            owners = (_owners(pre, self._params[:s0]) if pre else []) \
                + [[(stack, n)] for n, _ in stack.named_parameters()] \
                + (_owners(post, self._params[s1:]) if post else [])
            new = []
            for p, val, pl, slots in zip(self._params, values, self._pl, owners):
                q = torch.nn.Parameter(distribute_tensor(val, mesh, pl),
                                       requires_grad=p.requires_grad)
                for module, name in slots:
                    module._parameters[name] = q
                new.append(q)
            bpl = placements(mesh, P(pipe_axis))
            for name, val in zip(bnames, bvalues):
                stack._buffers[name] = distribute_tensor(val, mesh, bpl)
            self._params = new
            optimizer.params = list(new)
            optimizer._state = _map_slots(state, lambda j, x, k: distribute_tensor(
                x, mesh, self._slot_pl(j, x)))
        self._buffer_names = bnames

    def _slot_pl(self, j, x):
        """A slot shaped like its parameter is placed like it; another
        (Adafactor's factors) is replicated."""
        if tuple(x.shape) == tuple(self._params[j].shape):
            return self._pl[j]
        return placements(self.mesh, P())

    def _split(self, items):
        n_pre, n_post = self._n_pre, self._n_post
        end = len(items) - n_post
        return items[:n_pre], items[n_pre:end], items[end:]

    @property
    def _buffers(self):
        return [self.stack._buffers[n] for n in self._buffer_names]

    # ------------------------------------------------------------------
    def _owner(self, c):
        """The pipe rank of chunk ``c`` and its row in that rank's block."""
        if self.schedule == "interleaved_1f1b":
            return c % self._pipe.size
        return c // self._v

    def _row(self, c):
        return c // self._pipe.size if self.schedule == "interleaved_1f1b" else c % self._v

    def _grid(self, kind):
        key = (kind, self.n_micro)
        if key not in self._grids:
            C, M = self.stack.n_stages, self.n_micro
            if kind == "gpipe" or kind == "eval":
                self._grids[key] = _gpipe_grid(C, M, self._owner)
            else:
                self._grids[key] = _interleaved_grid(C, self._pipe.size, M)
        return self._grids[key]

    def _scope(self):
        d = self._data
        return contextlib.nullcontext() if d is None else _data_axis.scope(*d)

    def _rows(self, x, M):
        """This rank's rows of each microbatch of the global batch ``x``."""
        d = self._data
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by n_micro {M}")
        out = list(x.chunk(M))
        if d is not None:
            if out[0].shape[0] % d.size:
                raise ValueError(f"a microbatch of {out[0].shape[0]} rows does not divide "
                                 f"over the {d.size} ranks of the data axis")
            out = [t.chunk(d.size)[d.rank] for t in out]
        return out

    def _activation(self, pre_run, xs):
        """An empty tensor shaped like a stage's input (a message buffer):
        the shape of ``pre`` of this rank's rows, found once per input
        shape."""
        key = (tuple(xs[0].shape), xs[0].dtype, None if not pre_run else pre_run[0].dtype)
        meta = self._act_meta.get(key)
        if meta is None:
            a = xs[0]
            if self._pre_fn is not None:
                with torch.no_grad(), _traced_routes():
                    a = self._pre_fn(pre_run, a)
            meta = self._act_meta[key] = (tuple(a.shape), a.dtype)
        shape, dtype = meta
        return lambda: torch.empty(shape, dtype=dtype, device=xs[0].device)

    # ------------------------------------------------------------------
    def __call__(self, x, y):
        mesh, pipe = self.mesh, self._pipe
        S, M, v, cd = self.stack.n_stages, self.n_micro, self._v, self.compute_dtype
        dev = self._params[0].to_local().device
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        if cd is not None and x.is_floating_point():
            x = x.to(cd)
        xs, ys = self._rows(x, M), self._rows(y, M)
        lr = self.optimizer.lr
        last = self._owner(S - 1) == pipe.rank
        pre_p, stack_p, post_p = self._split(self._params)

        def copy(t):
            t = t.detach()
            return (t.to(cd) if cd is not None and t.is_floating_point() else t)

        with torch.no_grad():
            pre_run = [copy(p.to_local()).requires_grad_(p.requires_grad) for p in pre_p]
            post_run = [copy(p.to_local()).requires_grad_(p.requires_grad) for p in post_p]
            rows = [_rows_of(p, mesh, self.pipe_axis) for p in stack_p]
            chunk_run = [[copy(r[j]).requires_grad_(p.requires_grad)
                          for r, p in zip(rows, stack_p)] for j in range(v)]
        bufs = [b.to_local() for b in self._buffers]
        acc_pre = [torch.zeros(p.shape, dtype=p.dtype, device=dev) for p in pre_p]
        acc_post = [torch.zeros(p.shape, dtype=p.dtype, device=dev) for p in post_p]
        acc_stack = [torch.zeros(r.shape, dtype=r.dtype, device=dev) for r in rows]
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        live, head_dy = {}, {}
        inv_m = 1.0 / M

        def add(accs, grads):
            for a, g in zip(accs, grads):
                if g is not None:
                    a.add_(g.to(a.dtype))

        def head(outs, targets, scale):
            """The criterion over the microbatches ``outs``; returns the
            gradients by them and adds post's.  ``post`` runs on each
            microbatch with leaves of its own, so its products and its
            gradients have the microbatch's shape and the gradients sum in
            the masters' dtype, microbatch by microbatch, as under
            ``accum_steps``."""
            nonlocal loss_acc
            leaves = [[p.detach().requires_grad_(p.requires_grad) for p in post_run]
                      for _ in outs]
            with torch.enable_grad(), self._scope():
                out = [self._post_fn(q, o) if self._post_fn else o for q, o in zip(leaves, outs)]
                loss = self._criterion(torch.cat(out) if len(out) > 1 else out[0], targets)
            want = list(outs) + [p for q in leaves for p in q if p.requires_grad]
            g = torch.autograd.grad(loss, want, torch.full_like(loss, scale), allow_unused=True)
            k = len(outs)
            for q in leaves:
                live = [a for a, p in zip(acc_post, q) if p.requires_grad]
                add(live, g[k:k + len(live)])
                k += len(live)
            loss_acc = loss_acc + loss.detach().float() * scale
            return g[:len(outs)]

        def fwd(c, m, xin):
            j = self._row(c)
            with torch.enable_grad(), self._scope():
                if c == 0:
                    xin = self._pre_fn(pre_run, xs[m]) if self._pre_fn else xs[m]
                elif xin.is_floating_point():
                    xin.requires_grad_(True)
                if self._buffered:
                    out, nb = self._stage_fn(chunk_run[j], [b[j] for b in bufs], xin)
                else:
                    out = self._stage_fn(chunk_run[j], xin)
            _check_shape(out, xin)
            if self._buffered:
                with torch.no_grad():  # the EMA of a microbatch this chunk ran
                    for b, new in zip(bufs, nb):
                        b[j].copy_(new.to(b.dtype))
            live[(c, m)] = (xin, out)
            if c == S - 1 and self.schedule != "gpipe":
                head_dy[m] = head([out], ys[m], inv_m)[0]
            return out.detach()

        def bwd(c, m, dy):
            xin, out = live.pop((c, m))
            if c == S - 1:
                dy = head_dy.pop(m)
            j = self._row(c)
            params = [p for p in chunk_run[j] if p.requires_grad]
            want = list(params)
            take_dx = c > 0 and xin.requires_grad
            if take_dx:
                want.append(xin)
            extra = [p for p in pre_run if p.requires_grad] if c == 0 else []
            g = torch.autograd.grad(out, want + extra, dy, allow_unused=True)
            k = 0
            for r, p in enumerate(chunk_run[j]):
                if p.requires_grad:
                    if g[k] is not None:
                        acc_stack[r][j].add_(g[k].to(acc_stack[r].dtype))
                    k += 1
            if extra:
                add([a for a, p in zip(acc_pre, pre_run) if p.requires_grad], g[len(want):])
            return g[len(params)].detach() if take_dx else None

        like = self._activation(pre_run, xs)
        with _traced_routes():
            if self.schedule == "gpipe":
                fgrid, bgrid = self._grid("gpipe")
                _run_grid(fgrid, S, pipe, self._owner, fwd, bwd, like)
                if last:  # the criterion over the whole batch, as the JAX step's
                    dys = head([live[(S - 1, m)][1] for m in range(M)], torch.cat(ys), 1.0)
                    head_dy.update(enumerate(dys))
                _run_grid(bgrid, S, pipe, self._owner, fwd, bwd, like)
            else:
                _run_grid(self._grid("1f1b"), S, pipe, self._owner, fwd, bwd, like)
        assert not live and not head_dy
        del chunk_run, rows
        loss, grads = self._reduce(loss_acc, acc_pre + acc_stack + acc_post)
        pre_g, stack_g, post_g = self._split(grads)
        full = None
        if self.grad_transform is not None or not getattr(self.optimizer, "elementwise", False):
            full = [self._gather_pipe(g) for g in stack_g]
        if self.grad_transform is not None:
            out = self.grad_transform(pre_g + full + post_g)
            pre_g, full, post_g = self._split(list(out))
        self._update(pre_g, stack_g, full, post_g, lr)
        return loss

    def _reduce(self, loss, grads):
        """Pre and post gradients and the loss summed over the pipe axis
        (one rank holds each), then everything over the data axis, scaled
        as ``ShardedTrainStep._reduce`` scales."""
        pipe, data = self._pipe, self._data
        pre_g, stack_g, post_g = self._split(grads)
        with torch.no_grad():
            if pipe.size > 1:
                parts = pre_g + post_g + [loss.reshape(1)]
                flat = torch.cat([t.reshape(-1).float() for t in parts])
                dist.all_reduce(flat, group=pipe.group)
                new = _unflatten(flat, parts)
                loss = new[-1].reshape(())
                pre_g, post_g = new[:len(pre_g)], new[len(pre_g):-1]
            if data is not None:
                scale = 1.0 if getattr(self.criterion, "reduction", "mean") == "sum" \
                    else 1.0 / data.size
                parts = pre_g + stack_g + post_g + [loss.reshape(1)]
                flat = torch.cat([t.reshape(-1).float() for t in parts])
                dist.all_reduce(flat, group=data.group)
                flat.mul_(scale)
                new = _unflatten(flat, parts)
                loss = new[-1].reshape(())
                pre_g, stack_g, post_g = self._split(new[:-1])
        return loss, list(pre_g) + list(stack_g) + list(post_g)

    def _gather_pipe(self, rows):
        """A stacked gradient whole: every pipe rank's rows, in stacked row
        order."""
        pipe = self._pipe
        if pipe.size == 1:
            return rows
        parts = [torch.empty_like(rows) for _ in range(pipe.size)]
        dist.all_gather(parts, rows.contiguous(), group=pipe.group)
        return torch.cat(parts)

    def _update(self, pre_g, stack_g, full, post_g, lr):
        """The optimizer's update of each rank's blocks (an elementwise
        optimizer) or of the whole values, keeping the blocks."""
        from torch.distributed.tensor import Replicate

        opt, mesh = self.optimizer, self.mesh
        k = mesh.mesh_dim_names.index(self.pipe_axis)
        s0, s1 = self._n_pre, len(self._params) - self._n_post
        ew = getattr(opt, "elementwise", False)
        with torch.no_grad():
            if ew:
                grads = []
                for i, pl in enumerate(self._pl):
                    if s0 <= i < s1:
                        if full is not None:
                            g = local_block(full[i - s0], mesh, pl)
                        else:  # the rank's rows: cut over the other axes
                            inner = tuple(Replicate() if a == k else q for a, q in enumerate(pl))
                            g = local_block(stack_g[i - s0], mesh, inner)
                    else:
                        g = pre_g[i] if i < s0 else post_g[i - s1]
                    grads.append(g.contiguous())
                params = [p.to_local() for p in self._params]
                state = _map_slots(opt._state, lambda j, x, kk: x.to_local())
            else:
                grads = pre_g + full + post_g
                params = [p.full_tensor() for p in self._params]
                state = _map_slots(opt._state, lambda j, x, kk: x.full_tensor())
            new_params, new_state = opt.pure_update(params, grads, state, lr)
            for p, pl, new in zip(self._params, self._pl, new_params):
                if not ew:
                    new = local_block(new, mesh, pl)
                mine = p.to_local()
                if new.data_ptr() != mine.data_ptr():
                    mine.copy_(new)
            if ew:
                old = opt._state
                opt._state = _map_slots(new_state, lambda j, x, kk: old[kk][j]
                                        if x.data_ptr() == old[kk][j].to_local().data_ptr()
                                        else as_dtensor(x, mesh, old[kk][j].placements,
                                                        old[kk][j].shape))
            else:
                opt._state = _map_slots(new_state, lambda j, x, kk: as_dtensor(
                    local_block(x, mesh, self._slot_pl(j, x)).contiguous(), mesh,
                    self._slot_pl(j, x), x.shape))

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule grid.  ``gpipe`` and ``1f1b``:
        ``(S-1)/(M+S-1)``.  ``interleaved_1f1b``: ``(C-1)`` forward-only and
        ``(C-1)`` backward-only chunk slices around the steady phase, in all
        ``(C + q_last)/v`` full-tick equivalents with ``q_last = (M-1) mod P
        + C·((M-1) div P)``; for ``M`` a multiple of ``P``, ``(P-1)/(vM +
        P-1)``."""
        S, M = self.stack.n_stages, self.n_micro
        if self.schedule == "interleaved_1f1b":
            v = self.virtual_stages
            n_pipe = self._pipe.size
            q_last = (M - 1) % n_pipe + S * ((M - 1) // n_pipe)
            wall_ticks = (S + q_last) / v
            return (wall_ticks - M) / wall_ticks
        return (S - 1) / (M + S - 1)

    def eval_logits(self, x):
        """The pipelined forward in eval mode (BatchNorm on its running
        statistics, no EMA update) on the masters, over the same layout
        (chunks in logical order); every rank returns the global batch's
        output."""
        pipe, S, M = self._pipe, self.stack.n_stages, self.n_micro
        pre_p, stack_p, post_p = self._split(self._params)
        dev = self._params[0].to_local().device
        x = torch.as_tensor(x, device=dev)
        xs = self._rows(x, M)
        outs = {}
        with torch.no_grad(), _traced_routes():
            pre_run = [p.to_local() for p in pre_p]
            post_run = [p.to_local() for p in post_p]
            rows = [_rows_of(p, self.mesh, self.pipe_axis) for p in stack_p]
            bufs = [b.to_local() for b in self._buffers]

            def fwd(c, m, xin):
                j = self._row(c)
                with self._scope():
                    if c == 0:
                        xin = self._pre_fn(pre_run, xs[m]) if self._pre_fn else xs[m]
                    if self._buffered:
                        out, _ = self._eval_stage_fn([r[j] for r in rows],
                                                     [b[j] for b in bufs], xin)
                    else:
                        out = self._eval_stage_fn([r[j] for r in rows], xin)
                if c == S - 1:
                    outs[m] = out
                return out

            fgrid, _ = self._grid("eval")
            _run_grid(fgrid, S, pipe, self._owner, fwd, None, self._activation(pre_run, xs))
            mine = None
            last = self._owner(S - 1)
            if pipe.rank == last:
                cat = torch.cat([outs[m] for m in range(M)])
                mine = self._post_fn(post_run, cat) if self._post_fn else cat
                mine = _gather_rows(mine, self._data, M)
            return _bcast(mine, last, pipe.group, dev)


def _unflatten(flat, like):
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out
