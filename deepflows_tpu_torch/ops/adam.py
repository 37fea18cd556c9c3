"""Fused Adam (counterpart of ``fused_adam`` in
``deepflows_tpu/ops/pallas_kernels.py``): one elementwise pass of Adam.

- ``fused_adam(params, grads, vs, ss, hyper)``: the kernel wrapper
  (``csrc/fused_adam.cu``).  It takes one f32 tensor or a list of them for
  each of params, grads and the two moments, and updates every parameter
  in ONE launch, however many tensors the list holds.
- ``fused_adam_plain``: its plain PyTorch twin, the same expression one op
  at a time.

``hyper`` is a device f32[7] tensor ``[lr, beta1, beta2, eps,
weight_decay, 1 - beta1^t, 1 - beta2^t]``, so a training step builds it
without a host sync.  Per element, in the JAX kernel's order: g += p·wd
(L2 decay, not decoupled); v = v·β1 + g·(1-β1); s = s·β2 + g·g·(1-β2);
p -= lr·(v/bc1)/(√(s/bc2) + eps).  Both functions update p, v and s IN
PLACE (the JAX kernel returns new arrays) and return the three lists.

On CPU tensors the wrapper calls the plain twin; on CUDA tensors it
launches the kernel on the current stream or raises, and counts the launch
in ``fused_adam.launches``.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import I, L, P, check, on_card, on_device, stream

CHUNK = 4096  # elements per block


def _lists(params, grads, vs, ss):
    out = []
    for x in (params, grads, vs, ss):
        out.append([x] if isinstance(x, torch.Tensor) else list(x))
    if len({len(x) for x in out}) != 1:
        raise ValueError(f"list lengths differ: {[len(x) for x in out]}")
    return out


def fused_adam_plain(params, grads, vs, ss, hyper):
    """Plain twin of ``fused_adam``: the same update, in place."""
    params, grads, vs, ss = _lists(params, grads, vs, ss)
    lr, b1, b2, eps, wd, bc1, bc2 = hyper.unbind()
    with torch.no_grad():
        for p, g, v, s in zip(params, grads, vs, ss):
            g = g + p * wd
            v.copy_(v * b1 + g * (1 - b1))
            s.copy_(s * b2 + g * g * (1 - b2))
            p.copy_(p - lr * (v / bc1) / (torch.sqrt(s / bc2) + eps))
    return params, vs, ss


def fused_adam(params, grads, vs, ss, hyper):
    """Adam over every (p, g, v, s), in place, in one launch; returns
    (params, vs, ss)."""
    params, grads, vs, ss = _lists(params, grads, vs, ss)
    f32 = (torch.float32,)
    for i, (p, g, v, s) in enumerate(zip(params, grads, vs, ss)):
        check(f"params[{i}]", p, tuple(p.shape), f32)
        for name, t in (("grads", g), ("vs", v), ("ss", s)):
            check(f"{name}[{i}]", t, tuple(p.shape), f32)
    check("hyper", hyper, (7,), f32)
    if not on_card(*params, *grads, *vs, *ss, hyper):
        return fused_adam_plain(params, grads, vs, ss, hyper)
    dev = hyper.device
    rows, starts, blocks = [], [], 0
    for p, g, v, s in zip(params, grads, vs, ss):
        rows += [p.data_ptr(), g.data_ptr(), v.data_ptr(), s.data_ptr(), p.numel()]
        starts.append(blocks)
        blocks += -(-p.numel() // CHUNK)
    table = torch.tensor(rows + starts + [blocks], dtype=torch.int64).pin_memory()
    table = table.to(dev, non_blocking=True)
    fn = _build.c_function("fused_adam", "dft_fused_adam", (P, I, L, I, P, P))
    with on_device(dev):
        rc = fn(table.data_ptr(), len(params), blocks, CHUNK, hyper.data_ptr(), stream())
    _build.check(rc, "fused_adam")
    fused_adam.launches += 1
    return params, vs, ss


fused_adam.launches = 0
