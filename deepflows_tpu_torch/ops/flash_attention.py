"""Flash attention (counterpart of ``flash_attention`` in
``deepflows_tpu/ops/pallas_kernels.py``): softmax(q·kᵀ·scale + mask)·v
with the (L, L) scores never stored, forward and backward.

- ``flash_attention(q, k, v, causal=False, sm_scale=None, window=None)``:
  differentiable in q, k, v (an ``autograd.Function`` that saves q, k, v,
  out and lse).
- ``flash_attention_fwd`` / ``flash_attention_bwd``: the kernel wrappers
  (``csrc/flash_attention.cu``); the backward is a delta pass and one
  launch that writes dq, dk and dv.
- ``flash_attention_plain`` / ``flash_attention_bwd_plain``: their plain
  PyTorch twins, which materialise the scores.

Semantics, as in the JAX kernel: q (B, H, Lq, D), k and v (B, H, Lk, D),
f32 or bf16 (one dtype), D <= 128; scale 1/√D by default; with ``causal``
a key is hidden when kpos > qpos (top-left, both counted from 0 even when
Lq != Lk) and, with a ``window`` (which, as in JAX, only acts together
with ``causal``), when kpos <= qpos - window.  A row with no visible key
gives output 0 and lse -1e30.  The output is in q's dtype, lse (B·H, Lq)
f32.  P is rounded to v's dtype before the P·V product and dS to k's (q's)
dtype before the dq (dk) product; sums are f32.  delta = rowsum(dO·O), which
the JAX wrapper computes in jnp, is one more kernel that the backward's C
entry launches before its main kernel.

On CPU tensors the wrappers call the plain twins; on CUDA tensors they
launch the kernel on the current stream or raise, and count the launch in
``<wrapper>.launches`` and by route in ``<wrapper>.routes``.  The
forward's kernel is chosen by ``_fwd_route`` and the backward's by
``_bwd_route``, from dtype, D, strides and alignment: bf16 that TMA can
read takes the wgmma kernel, other bf16 the mma.sync kernel, f32 the
CUDA-core kernel; a CUDA call never falls back to another route.  q, k,
v, out and dout may be strided views (the last axis contiguous), so
MultiheadAttention's head views need no copy; the output is allocated (B,
Lq, H, D) and returned as its (B, H, Lq, D) view.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._common import FLOATS, F, I, P, check, on_card, on_device, stream

NEG_INF = -1e30
MAX_HEAD_DIM = 128


def _scale(d, sm_scale):
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _mask(lq, lk, causal, window, device):
    """(Lq, Lk) bool, True where a key is hidden."""
    if not causal:
        return torch.zeros((lq, lk), dtype=torch.bool, device=device)
    qpos = torch.arange(lq, device=device)[:, None]
    kpos = torch.arange(lk, device=device)[None, :]
    mask = kpos > qpos
    if window:
        mask = mask | (kpos <= qpos - window)
    return mask


def flash_attention_plain(q, k, v, causal=False, sm_scale=None, window=None):
    """Plain twin of ``flash_attention_fwd``: returns (out, lse (B·H, Lq))."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = _scale(d, sm_scale)
    mask = _mask(lq, lk, causal, window, q.device)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(mask, NEG_INF, s)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (p.to(v.dtype).float() @ v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, lq)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False, sm_scale=None,
                              window=None):
    """Plain twin of ``flash_attention_bwd``: returns (dq, dk, dv)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = _scale(d, sm_scale)
    mask = _mask(lq, lk, causal, window, q.device)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.where(mask, 0.0, torch.exp(s - lse.reshape(b, h, lq, 1)))
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    dp = dout.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta) * scale
    dv = p.to(dout.dtype).float().transpose(-1, -2) @ dout.float()
    dq = ds.to(k.dtype).float() @ k.float()
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(q, k, v):
    check("q", q, (None, None, None, None), FLOATS, contiguous=False)
    b, h, lq, d = q.shape
    check("k", k, (b, h, None, d), (q.dtype,), contiguous=False)
    check("v", v, (b, h, k.shape[2], d), (q.dtype,), contiguous=False)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM}, got {d}")


def _rows(t):
    """``t`` with a contiguous last axis."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _new_like_heads(t):
    """An empty (B, H, L, D) tensor laid out (B, L, H, D), as the projections
    that produce and consume the head views are."""
    b, h, l, d = t.shape
    return torch.empty((b, l, h, d), dtype=t.dtype, device=t.device).transpose(1, 2)


def _aligned(tensors, positive=False):
    """Whether every tensor of ``tensors`` has a contiguous last axis, (B,
    H, L) strides that are multiples of 8 elements (positive, if asked) and
    a 16-byte aligned base.  One pass: the forward asks it on every call."""
    for t in tensors:
        *strides, last = t.stride()
        if last != 1 or t.data_ptr() % 16:
            return False
        for s in strides:
            if s % 8 or (positive and s <= 0):
                return False
    return True


def _meta(q, k, causal, window, tensors, extra=()):
    """The kernel's int64 header: B, H, Lq, Lk, D, causal, window, whether
    every row starts 16-byte aligned (then the bf16 kernel loads 16 bytes at
    a time), the (B, H, L) element strides of ``tensors``, then ``extra``."""
    b, h, lq, d = q.shape
    strides = [s for t in tensors for s in t.stride()[:3]]
    vec = d % 8 == 0 and _aligned(tensors)
    vals = [b, h, lq, k.shape[2], d, int(bool(causal)), int(window or 0), int(vec)] + strides
    vals += list(extra)
    return (ctypes.c_longlong * len(vals))(*vals)


ROUTES = ("f32", "mma", "wgmma")  # the kernels' routes, by their code in the header


def _route(q, tensors):
    """``"wgmma"`` (the TMA-fed kernel) for bf16 where TMA can read every
    tensor of ``tensors`` — D % 8 == 0, every (B, H, L) stride a positive
    multiple of 8 elements, every base 16-byte aligned, the last axis
    contiguous; ``"mma"`` (mma.sync) for every other bf16 call; ``"f32"``
    for f32."""
    if q.dtype != torch.bfloat16:
        return "f32"
    d = q.shape[-1]
    if d % 8 == 0 and d <= MAX_HEAD_DIM and _aligned(tensors, positive=True):
        return "wgmma"
    return "mma"


def _fwd_route(q, k, v):
    """The forward kernel a call takes, from dtype, D, strides and alignment
    of q, k and v alone (``_route``)."""
    return _route(q, (q, k, v))


def _bwd_route(q, k, v, dout):
    """The backward kernel a call takes, from dtype, D, strides and
    alignment of q, k, v and dout alone (``_route``); dq, dk and dv are the
    wrapper's own, always aligned."""
    return _route(q, (q, k, v, dout))


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, window=None):
    """Forward kernel: returns (out in q's dtype, lse f32 (B·H, Lq))."""
    _check_qkv(q, k, v)
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal, sm_scale, window)
    b, h, lq, d = q.shape
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = _new_like_heads(q)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    route = ROUTES.index(_fwd_route(q, k, v))  # the C entry encodes wgmma's tensor maps
    meta = _meta(q, k, causal, window, (q, k, v, out), (route,))
    fn = _build.c_function(
        "flash_attention", "dft_flash_fwd", (P, P, P, P, P, P, F, I, P)
    )
    with on_device(q.device):
        rc = fn(meta, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), _scale(d, sm_scale), int(q.dtype == torch.bfloat16),
                stream())
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[ROUTES[route]] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = dict.fromkeys(ROUTES, 0)  # launches by route, never reset


def _stats_layout(route, lq):
    """(row length, planes) of the backward's f32 scratch, which the C
    entry's delta pass fills: delta (B·H, Lq) for the mma.sync and f32
    kernels; for the wgmma kernel delta and lse·log2e, each (B·H, Lq rounded
    up to 128) with zeros past Lq, so that each tile of 64 or 128 rows of
    them is one aligned bulk copy."""
    if route == "wgmma":
        return -(-lq // 128) * 128, 2
    return lq, 1


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, sm_scale=None, window=None):
    """Backward kernels: returns (dq, dk, dv) in q's, k's and v's dtypes.
    The C entry launches the delta pass, then the main kernel (one launch
    for dq, dk and dv), on the current stream: one call, one count."""
    _check_qkv(q, k, v)
    b, h, lq, d = q.shape
    check("out", out, (b, h, lq, d), (q.dtype,), contiguous=False)
    check("dout", dout, (b, h, lq, d), FLOATS, contiguous=False)
    check("lse", lse, (b * h, lq), (torch.float32,))
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if not on_card(q, k, v, out, lse, dout):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, sm_scale, window)
    q, k, v, dout, out = _rows(q), _rows(k), _rows(v), _rows(dout), _rows(out)
    dq, dk, dv = _new_like_heads(q), _new_like_heads(k), _new_like_heads(v)
    route = _bwd_route(q, k, v, dout)
    ld, planes = _stats_layout(route, lq)
    stats = torch.empty((planes, b * h, ld), dtype=torch.float32, device=q.device)
    meta = _meta(q, k, causal, window, (q, k, v, dout, dq, dk, dv),
                 (ROUTES.index(route), *out.stride()[:3], ld))
    fn = _build.c_function(
        "flash_attention", "dft_flash_bwd", (P, P, P, P, P, P, P, P, P, P, P, F, I, P)
    )
    with on_device(q.device):
        rc = fn(meta, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                out.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _scale(d, sm_scale),
                int(q.dtype == torch.bfloat16), stream())
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(ROUTES, 0)  # launches by route, never reset


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, window=None):
    """softmax(q·kᵀ·scale + mask)·v, differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale, window)
