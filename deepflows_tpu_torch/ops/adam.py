"""Fused Adam (counterparts of ``fused_adam`` and ``fused_adam_sr`` in
``deepflows_tpu/ops/pallas_kernels.py``): one elementwise pass of Adam.

- ``fused_adam(params, grads, vs, ss, hyper)``: the kernel wrapper
  (``csrc/fused_adam.cu``).  It takes one f32 tensor or a list of them for
  each of params, grads and the two moments, and updates every parameter
  in ONE launch, however many tensors the list holds.
- ``fused_adam_sr(params, grads, vs, ss, hyper, step, indices, bits)``:
  the same for bf16 parameters (``csrc/fused_adam_sr.cu``): Adam in f32
  from the bf16 value, the new value stochastically rounded to bf16 with
  Philox bits keyed by the JAX package's seed t·1009 + i, or with the
  given ``bits``.
- ``fused_adam_plain`` / ``fused_adam_sr_plain``: their plain PyTorch
  twins, the same expressions one op at a time; the SR twin computes the
  kernel's Philox stream in int64 ops, so the two agree bit for bit.
- ``stochastic_round_bf16``: the rounding alone, for the tests.

``hyper`` is a device f32[7] tensor ``[lr, beta1, beta2, eps,
weight_decay, 1 - beta1^t, 1 - beta2^t]``, so a training step builds it
without a host sync.  Per element, in the JAX kernel's order: g += p·wd
(L2 decay, not decoupled); v = v·β1 + g·(1-β1); s = s·β2 + g·g·(1-β2);
p -= lr·(v/bc1)/(√(s/bc2) + eps).  The functions update p, v and s IN
PLACE (the JAX kernels return new arrays) and return the three lists.

On CPU tensors the wrappers call the plain twins; on CUDA tensors they
launch the kernel on the current stream or raise, and count the launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from . import _build, _common
from ._common import I, L, P, check, costed, nbytes, on_card, on_device, stream

CHUNK = 4096  # elements per block


def _device_table(values, dev):
    """The kernel's table of pointers and block starts, copied to the card
    from pinned host memory.  A captured copy reads its host buffer again
    at every replay: so a call in ``jit.StepGraphs``' warm-up sets a pinned
    buffer aside, the captured call copies from it, and the graph keeps
    it."""
    host_of_graph = _common.graph_host
    if torch.cuda.is_current_stream_capturing():
        spare = [] if host_of_graph is None else host_of_graph.spare.get(len(values), [])
        if not spare:
            raise RuntimeError("fused Adam is captured only inside jit.StepGraphs, after the "
                               "warm-up call")
        host = spare.pop()
        host.copy_(torch.tensor(values, dtype=torch.int64))
        host_of_graph.kept.append(host)
    else:
        host = torch.tensor(values, dtype=torch.int64).pin_memory()
        if host_of_graph is not None:
            host_of_graph.spare.setdefault(len(values), []).append(torch.empty_like(host)
                                                                    .pin_memory())
    return host.to(dev, non_blocking=True)


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


def _adam_cost(params, grads, vs, ss, hyper):
    """No products (the bound is the bytes): p, g, v and s read, p, v and s
    written, and the hyper-parameters."""
    params, grads, vs, ss = _lists(params, grads, vs, ss)
    return 0, nbytes(*params, *grads, *vs, *ss) + nbytes(*params, *vs, *ss) + nbytes(hyper)


def _adam_sr_cost(params, grads, vs, ss, hyper, step, indices=None, bits=None):
    """``fused_adam``'s count, and the step read (bf16 p: 22 bytes an
    element with a bf16 gradient)."""
    ops, moved = _adam_cost(params, grads, vs, ss, hyper)
    return ops, moved + nbytes(step)


@costed(_adam_cost)
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
    table = _device_table(rows + starts + [blocks], dev)
    fn = _build.c_function("fused_adam", "dft_fused_adam", (P, I, L, I, P, P))
    with on_device(dev):
        rc = fn(table.data_ptr(), len(params), blocks, CHUNK, hyper.data_ptr(), stream())
    _build.check(rc, "fused_adam")
    fused_adam.launches += 1
    return params, vs, ss


fused_adam.launches = 0


# ------------------------------------------------- stochastic-rounding Adam
_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, c):
    """(hi, lo) 32-bit halves of the 64-bit product m·c, for a constant
    m < 2^32 and an int64 tensor c of u32 values.  c is split into 16-bit
    halves so that no partial product leaves int64."""
    a = m * (c & 0xFFFF)  # < 2^48
    b = m * (c >> 16)  # < 2^48
    low = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (low >> 32), low & _U32


def philox4x32_10(key, counter):
    """Philox4x32-10 in int64 tensor ops, the generator of
    ``csrc/fused_adam_sr.cu``: key (k0, 0) with k0 an int64 tensor (any
    shape broadcastable to ``counter``), counter (c, c >> 32, 0, 0) for each
    int64 ``counter`` value.  Returns (..., 4) int64 holding u32 words; every
    add and product is taken mod 2^32 where the kernel's u32 arithmetic
    wraps."""
    k0 = key & _U32
    k1 = torch.zeros_like(k0)
    c0, c1 = counter & _U32, counter >> 32
    c2 = c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return torch.stack((c0, c1, c2, c3), -1)


def sr_seed(step, index: int):
    """The JAX package's per-(step, parameter) seed t·1009 + i, as the u32
    of its int32 wrap-around (an int64 tensor on ``step``'s device)."""
    return (step.reshape(()).to(torch.int64) * 1009 + index) & _U32


def philox_bits(step, index: int, n: int):
    """The kernel's n random u32 words (int64) for tensor ``index`` at step
    ``step``: Philox counter e // 4, word e % 4, for element e."""
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=step.device)
    return philox4x32_10(sr_seed(step, index), groups).reshape(-1)[:n]


def stochastic_round_bf16(x, bits):
    """f32 -> bf16 by adding the low 16 bits of ``bits`` (u32 values, as
    int32, int64 or uint32) to the f32 bit pattern and truncating: the
    JAX package's ``_stochastic_round_bf16``, bit for bit."""
    xi = x.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
    xi = (xi + (bits.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    xi = torch.where(xi >= 2**31, xi - 2**32, xi)  # as an int32 bit pattern
    return xi.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def _sr_lists(params, grads, vs, ss, indices, bits):
    params, grads, vs, ss = _lists(params, grads, vs, ss)
    indices = list(range(len(params))) if indices is None else [int(i) for i in indices]
    if len(indices) != len(params):
        raise ValueError(f"{len(indices)} indices for {len(params)} tensors")
    if bits is not None:
        bits = [bits] if isinstance(bits, torch.Tensor) else list(bits)
        if len(bits) != len(params):
            raise ValueError(f"{len(bits)} bit tensors for {len(params)} tensors")
    return params, grads, vs, ss, indices, bits


def fused_adam_sr_plain(params, grads, vs, ss, hyper, step, indices=None, bits=None):
    """Plain twin of ``fused_adam_sr``: the same update and the same random
    bits (Philox in int64 ops, or ``bits``), in place."""
    params, grads, vs, ss, indices, bits = _sr_lists(params, grads, vs, ss, indices, bits)
    lr, b1, b2, eps, wd, bc1, bc2 = hyper.unbind()
    with torch.no_grad():
        for k, (p, g, v, s, i) in enumerate(zip(params, grads, vs, ss, indices)):
            p32 = p.float()
            g = g.float() + p32 * wd
            v.copy_(v * b1 + g * (1 - b1))
            s.copy_(s * b2 + g * g * (1 - b2))
            new = p32 - lr * (v / bc1) / (torch.sqrt(s / bc2) + eps)
            r = philox_bits(step, i, p.numel()) if bits is None else bits[k].reshape(-1)
            p.copy_(stochastic_round_bf16(new.reshape(-1), r).view(p.shape))
    return params, vs, ss


@costed(_adam_sr_cost)
def fused_adam_sr(params, grads, vs, ss, hyper, step, indices=None, bits=None):
    """Adam with stochastic rounding over every (p bf16, g bf16 or f32, v,
    s f32), in place, in one launch; returns (params, vs, ss).

    ``step`` is the device int32 step count t (from 1), ``indices`` each
    tensor's position i in the optimizer's parameter list (default 0, 1,
    …): the random bits of tensor i at step t are Philox's, keyed by
    t·1009 + i.  ``bits`` (one int32 tensor of u32 words per tensor, p's
    size) replaces them: the entry the tests feed the JAX package's bits."""
    params, grads, vs, ss, indices, bits = _sr_lists(params, grads, vs, ss, indices, bits)
    bf16, f32 = (torch.bfloat16,), (torch.float32,)
    for k, (p, g, v, s) in enumerate(zip(params, grads, vs, ss)):
        check(f"params[{k}]", p, tuple(p.shape), bf16)
        check(f"grads[{k}]", g, tuple(p.shape), (torch.bfloat16, torch.float32))
        for name, t in (("vs", v), ("ss", s)):
            check(f"{name}[{k}]", t, tuple(p.shape), f32)
        if bits is not None:
            check(f"bits[{k}]", bits[k], tuple(p.shape), (torch.int32,))
    check("hyper", hyper, (7,), f32)
    if step.numel() != 1 or step.dtype != torch.int32:
        raise TypeError(f"step must be one int32 value, got {step.dtype} {tuple(step.shape)}")
    if not on_card(*params, *grads, *vs, *ss, *(bits or ()), hyper, step):
        return fused_adam_sr_plain(params, grads, vs, ss, hyper, step, indices, bits)
    dev = hyper.device
    rows, starts, blocks = [], [], 0
    for k, (p, g, v, s, i) in enumerate(zip(params, grads, vs, ss, indices)):
        b = 0 if bits is None else bits[k].data_ptr()
        ptrs = (p.data_ptr(), g.data_ptr(), v.data_ptr(), s.data_ptr(), b)
        g16 = g.dtype == torch.bfloat16
        aligned = all(a % m == 0 for a, m in zip(ptrs, (8, 8 if g16 else 16, 16, 16, 16)))
        rows += [*ptrs, p.numel(), i, int(g16), int(aligned)]
        starts.append(blocks)
        blocks += -(-p.numel() // CHUNK)
    table = _device_table(rows + starts + [blocks], dev)
    step = step.contiguous()
    fn = _build.c_function("fused_adam_sr", "dft_fused_adam_sr", (P, I, L, I, P, P, I, P))
    with on_device(dev):
        rc = fn(table.data_ptr(), len(params), blocks, CHUNK, hyper.data_ptr(),
                step.data_ptr(), int(bits is not None), stream())
    _build.check(rc, "fused_adam_sr")
    fused_adam_sr.launches += 1
    return params, vs, ss


fused_adam_sr.launches = 0
