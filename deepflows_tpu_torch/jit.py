"""Whole steps: training and evaluation (counterpart of ``CompiledTrainStep``,
``CompiledEvalStep`` and the ``jit`` decorator of ``deepflows_tpu/jit.py``),
and the CUDA graphs that stand in for ``jax.jit`` where a step repeats
(``StepGraphs``).

The JAX package traces a step into one XLA program.  Here a training step
runs EAGERLY, one PyTorch op (or kernel launch) at a time, with the same
contract; capturing it in a CUDA graph is later work.  Under lazy mode the
steps run outside the recorder, after a flush (``backend/lazy.py``).  The
KV-cache decoder's step is captured once and replayed once a token
(``models/decoding.py``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from .autograd import flag_kept
from .backend import lazy as _lazy
from .backend.torch_kernels import plain
from .config import config
from .ops import KERNELS, _common
from .tensor import Tensor


def _owners(model, params):
    """Every (module, name) slot that holds each parameter (a tied parameter
    has several)."""
    index = {id(p): i for i, p in enumerate(params)}
    slots = [[] for _ in params]
    for module in model.modules():
        for name, p in module._parameters.items():
            if p is not None and id(p) in index:
                slots[index[id(p)]].append((module, name))
    return slots


@contextlib.contextmanager
def _traced_routes():
    """``config.use_pallas`` off for the call: the JAX package's traced
    steps never take its eager kernel routes (``nn.functional.linear``,
    ``BackendTensor @``), so neither do the port's whole steps."""
    saved = config.use_pallas
    config.use_pallas = False
    try:
        yield
    finally:
        config.use_pallas = saved


def _untaped(x):
    """A tape ``Tensor`` as a plain tensor on the same storage (a step's
    own forward and backward never record on the tape); anything else as
    it is."""
    return plain(x) if isinstance(x, Tensor) else x


def jit(fn: Callable) -> Callable:
    """The JAX package's ``jit(fn)`` (one compiled program per input shape)
    as an eager wrapper: ``fn`` runs with gradients off and
    ``config.use_pallas`` off, as it would traced.  Arguments that are not
    tensors (numpy arrays, lists) are made tensors on the device of the
    first tensor argument, or on the card when there is none."""
    import functools

    import numpy as np

    from .device import Device

    @functools.wraps(fn)
    def wrapper(*args):
        args = [_untaped(a) for a in args]
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
        args = [a if isinstance(a, torch.Tensor)
                else torch.as_tensor(np.asarray(a), device=dev or Device(None))
                for a in args]
        with torch.no_grad(), _traced_routes():
            return fn(*args)

    return wrapper


class CompiledTrainStep:
    def __init__(
        self,
        model,
        optimizer,
        criterion: Callable,
        donate: bool = True,
        metrics_fn: Optional[Callable] = None,
        compute_dtype=None,
        grad_transform: Optional[Callable] = None,
        accum_steps: int = 1,
    ):
        """One call ``step(x, y)`` runs forward, ``criterion(model(x), y)``,
        backward and the optimizer's update, and returns the loss.

        - ``optimizer.lr`` is read at every call.
        - The optimizer may hold a subset of the model's parameters, matched
          by identity; the others are not updated.
        - ``grad_transform`` maps the list of gradients (None for a
          parameter without one) before the update.
        - ``compute_dtype=torch.bfloat16``: forward and backward run on
          bf16 copies of every parameter (and of a floating input); the
          gradients come back as f32, the optimizer updates the f32 master
          weights, and the loss returns as f32.  The copies are bound into
          the model's modules for the call, so a criterion that holds one
          of the model's modules (``nn.LMHeadCrossEntropy``) computes with
          them too.
        - ``compute_dtype=None``: forward and backward run on the
          parameters as they are; with bf16 parameters
          (``Module.bfloat16()``) the gradients reach the optimizer in bf16
          and the loss returns in the criterion's dtype, as in the JAX
          package (``Adam(stochastic_round=True)`` updates such weights).
        - Buffers are not copied: the forward updates BatchNorm's running
          statistics in place, in their own dtype (f32 under a bf16
          ``compute_dtype``, as the JAX package keeps them), once a step
          with or without ``nn.Remat``.
        - ``config.use_pallas`` is off during the call.
        - ``donate`` is accepted for the JAX package's signature; the update
          reuses the masters' memory where the optimizer works in place.
        - ``accum_steps=N`` accumulates gradients: the batch is split into N
          microbatches (it must divide), each runs forward and backward in
          turn (activation memory is one microbatch's), the gradients are
          summed in f32 under a ``compute_dtype`` and scaled by 1/N unless
          the criterion's ``reduction`` is ``"sum"``, and one update
          follows.  The loss returned is the microbatch losses' mean (their
          sum under ``"sum"``).  BatchNorm's EMA runs once a microbatch and
          dropout draws a new mask for each.
        - ``metrics_fn(output, y)`` is computed each microbatch, without
          gradients, and its tensors (any nesting of lists, tuples and
          dicts) averaged over the microbatches into ``step._last_metrics``
          (None without a ``metrics_fn``)."""
        if int(accum_steps) < 1:
            raise ValueError("accum_steps must be >= 1")
        if _lazy.recording():
            _lazy.flush()
        self.model = model
        self.optimizer = optimizer
        self.criterion = criterion
        self.metrics_fn = metrics_fn
        self.compute_dtype = compute_dtype
        self.grad_transform = grad_transform
        self.accum_steps = int(accum_steps)
        self._last_metrics = None
        self._params = [p for _, p in model.named_parameters()]
        by_id = {id(p): i for i, p in enumerate(self._params)}
        try:
            self._opt_index = [by_id[id(p)] for p in optimizer.params]
        except KeyError:
            raise ValueError("optimizer holds parameters that are not in the model") from None
        self._slots = _owners(model, self._params)
        optimizer._ensure_state()
        with flag_kept():  # train() sets the tape's grad flag
            self.model.train()

    def _bind(self, tensors):
        for slots, t in zip(self._slots, tensors):
            for module, name in slots:
                module._parameters[name] = t

    def _full_params(self):
        """Each parameter's whole value (``ShardedTrainStep`` gathers
        them)."""
        return [p.detach() for p in self._params]

    def _compute_copies(self):
        cd = self.compute_dtype
        copies = []
        with torch.no_grad():
            for p, c in zip(self._params, self._full_params()):
                if cd is not None and c.is_floating_point():
                    c = c.to(cd)
                copies.append(c.requires_grad_(p.requires_grad))
        return copies

    def _microbatches(self, x, y):
        """The (x, y) pairs of the microbatches this process computes."""
        n = self.accum_steps
        return zip(x.chunk(n), y.chunk(n))

    def _scope(self):
        """A context the forward and backward run in."""
        return contextlib.nullcontext()

    def _reduce(self, loss, grads, metrics):
        """The step's loss, gradients and metrics from this process's
        (a sharded step sums them over the data axis)."""
        return loss, grads, metrics

    def _fwd_bwd(self, copies, need, x, y):
        """One microbatch's forward and backward on the bound copies: its
        loss, the gradients of ``need`` and its metrics."""
        with torch.enable_grad(), _traced_routes(), self._scope():
            out = self.model(x)
            loss = self.criterion(out, y)
            found = torch.autograd.grad(
                loss, [copies[i] for i in need], allow_unused=True
            )
        metrics = None
        if self.metrics_fn is not None:
            with torch.no_grad():
                metrics = self.metrics_fn(out, y)
        return loss.detach(), found, metrics

    @_lazy.eager
    def __call__(self, x, y):
        dev = self._params[0].device
        x = torch.as_tensor(_untaped(x), device=dev)
        y = torch.as_tensor(_untaped(y), device=dev)
        cd = self.compute_dtype
        if cd is not None and x.is_floating_point():
            x = x.to(cd)
        n = self.accum_steps
        if x.shape[0] % n:
            raise ValueError(f"batch size {x.shape[0]} not divisible by accum_steps {n}")
        lr = self.optimizer.lr
        copies = self._compute_copies()
        need = [i for i, c in enumerate(copies) if c.requires_grad]
        grads = [None] * len(copies)
        losses, metrics = [], []
        self._bind(copies)
        try:
            for xm, ym in self._microbatches(x, y):
                loss, found, m = self._fwd_bwd(copies, need, xm, ym)
                losses.append(loss)
                metrics.append(m)
                for i, g in zip(need, found):
                    if g is None:
                        continue
                    if grads[i] is not None:
                        grads[i].add_(g)
                        continue
                    # widened to f32 (under a compute_dtype) and laid out
                    # contiguously in one copy: autograd hands some gradients
                    # over strided (the MoE expert stacks'); with microbatches
                    # always a copy, which the others are added into
                    if cd is not None or n > 1:
                        g = g.to(torch.float32 if cd is not None else g.dtype,
                                 memory_format=torch.contiguous_format, copy=n > 1)
                    grads[i] = g
        finally:
            self._bind(self._params)
        loss = losses[0]
        if n > 1:
            scale = 1.0 if getattr(self.criterion, "reduction", "mean") == "sum" else 1.0 / n
            grads = [None if g is None else g.mul_(scale) for g in grads]
            loss = torch.stack(losses).sum() * scale
        loss, grads, self._last_metrics = self._reduce(loss, grads, _mean_metrics(metrics))
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        self._update(grads, lr)
        return loss.float() if cd is not None else loss

    def _update(self, grads, lr):
        """The optimizer's update of the parameters it holds."""
        opt = self.optimizer
        data = [self._params[i].data for i in self._opt_index]
        with torch.no_grad():
            new_params, opt._state = opt.pure_update(
                data, [grads[i] for i in self._opt_index], opt._state, lr
            )
        for i, old, new in zip(self._opt_index, data, new_params):
            if new is not old:
                self._params[i].data = new


def _mean_metrics(per_micro):
    """The microbatches' metrics averaged leaf by leaf (equal microbatches,
    so a rate equals its whole-batch value); None without metrics."""
    first = per_micro[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _mean_metrics([m[k] for m in per_micro]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_mean_metrics(list(ms)) for ms in zip(*per_micro))
    if len(per_micro) == 1:
        return first
    return sum(per_micro[1:], first) / len(per_micro)


class CompiledEvalStep:
    """Inference: the model's forward in eval mode (BatchNorm on its running
    statistics, dropout off) without gradients and with
    ``config.use_pallas`` off, returning its raw output; the model's mode
    is restored afterwards."""

    def __init__(self, model):
        self.model = model

    @_lazy.eager
    def __call__(self, x):
        dev = next(self.model.parameters()).device
        was_training = self.model.training
        with flag_kept():  # eval() and train() set the tape's grad flag
            self.model.eval()
            try:
                with torch.no_grad(), _traced_routes():
                    return self.model(torch.as_tensor(_untaped(x), device=dev))
            finally:
                if was_training:
                    self.model.train()


class _Captured:
    """One captured step: its graph, the kernel launches one replay makes
    (``(wrapper, count)`` pairs), the device memory its capture added (its
    private pool, or what it grew a shared one by), the seconds the
    warm-up and capture took, the replays so far, and the pinned host
    buffers its copies read (``ops._common.GraphHost``)."""

    def __init__(self, graph, launched, pool_bytes, capture_s, host=()):
        self.graph = graph
        self.host = host
        self.launched = launched
        self.pool_bytes = pool_bytes
        self.capture_s = capture_s
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self.launched:
            wrapper.launches += n


class StepGraphs:
    """Step functions replayed from CUDA graphs, one graph per key: the
    counterpart of the ``jax.jit`` caches of the JAX package's decoder
    (``deepflows_tpu/models/decoding.py:221-233``), whose static arguments
    the key holds.

    ``run(key, fn, times)`` makes ``times`` calls of ``fn`` on the card.
    The first run of a key makes the first call eagerly on a side stream:
    that warm-up is a real step, and it runs every lazy initialisation a
    capture must not meet (kernel builds, ``cudaFuncSetAttribute``, cuBLAS
    handles).  Then one call of ``fn`` is captured, not run, into a graph
    with a private memory pool (but see ``shared_pool``), and the other
    calls replay it.  Later runs of the key only replay.  So ``fn`` may
    read and write only tensors that outlive the graph, and every value
    that changes from one call to the next must live in such a tensor on
    the card.  Each generator in ``generators`` is registered with the
    graph, so a replay draws what the eager call would draw at the
    generator's offset, and moves the offset on as the eager call would.  A capture that fails raises;
    nothing falls back to eager calls.

    The kernel launch counts (``<wrapper>.launches`` of ``ops.KERNELS``)
    count launches that ran on the card: the capture's are taken off
    again and added back at every replay.

    With ``shared_pool`` every graph of this object is captured into one
    memory pool, so the card holds the largest graph's temporaries rather
    than the sum over the keys.  The caller then replays the graphs one at
    a time, never two at once, and ``fn`` leaves nothing of the capture's
    own allocations alive.
    """

    def __init__(self, shared_pool: bool = False):
        self._graphs = {}
        self._shared = shared_pool
        self._pool = None  # the shared pool's handle, made at the first capture

    def __contains__(self, key):
        return key in self._graphs

    def __getitem__(self, key) -> _Captured:
        return self._graphs[key]

    def run(self, key, fn: Callable[[], None], times: int, generators=()) -> None:
        if times <= 0:
            return
        captured = self._graphs.get(key)
        if captured is None:
            if self._shared and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            captured = self._graphs[key] = self._capture(fn, generators, self._pool)
            times -= 1
        for _ in range(times):
            captured.replay()

    @staticmethod
    def _capture(fn, generators, pool=None) -> _Captured:
        t0 = time.perf_counter()
        host, prev = _common.GraphHost(), _common.graph_host
        _common.graph_host = host
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            before = [k.launches for k in KERNELS]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # as the capture does first: the pool is what it adds
            reserved = torch.cuda.memory_reserved()
            # thread_local: another thread's work on the card (a server's other
            # requests) does not break this capture
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                fn()
        finally:
            _common.graph_host = prev
        launched = []
        for k, n in zip(KERNELS, before):
            if k.launches != n:
                launched.append((k, k.launches - n))
                k.launches = n  # the capture ran nothing
        added = torch.cuda.memory_reserved() - reserved
        return _Captured(graph, tuple(launched), added, time.perf_counter() - t0, host.kept)
