"""Fused LM-head cross-entropy (counterpart of ``fused_linear_ce`` in
``deepflows_tpu/ops/pallas_kernels.py``): per-row loss of the head
``x @ w + b`` against integer targets, with the (N, V) logits never stored,
forward and backward.

- ``fused_linear_ce(x, w, b, targets)``: per-row loss (N,) f32,
  differentiable in x, w and b (an ``autograd.Function`` that saves x, w,
  b, the targets and lse); targets get no gradient.
- ``fused_linear_ce_fwd`` / ``fused_linear_ce_bwd``: the kernel wrappers
  (``csrc/fused_linear_ce.cu``).  The forward's kernel is chosen by
  ``_fwd_route`` (bf16 that TMA can read on wgmma, other bf16 on mma.sync,
  f32 on the CUDA cores; a CUDA call never falls back to another route)
  and its vocab split by ``_fwd_plan``; it counts its launches by route in
  ``fused_linear_ce_fwd.routes``.  The backward is one launch that writes
  dx, dw and db, for bf16 x and w as clusters that split D (``_bwd_plan``).
- ``fused_linear_ce_plain`` / ``fused_linear_ce_bwd_plain``: their plain
  PyTorch twins, which materialise the logits.

x (N, D) and w (D, V) share a dtype, f32 or bf16; b (V,) is f32 or bf16;
targets (N,) are integers.  loss_i = lse_i - logit_i,t_i with logits =
x·w in f32 plus b; a target outside [0, V) matches no class, so its loss
is lse.  Backward: dl = (softmax - onehot)·g, rounded to w's dtype before
dx = dl·wᵀ and to x's before dw = xᵀ·dl; db sums the f32 dl.  dx, dw and
db come out in x's, w's and b's dtypes.  The backward kernel takes D up to
``MAX_DIM[x.dtype]``: 4096 in bf16, 1024 in f32.

On CPU tensors the wrappers call the plain twins; on CUDA tensors they
launch the kernel on the current stream or raise, and count the launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import FLOATS, I, P, check, costed, nbytes, on_card, on_device, stream
from ..tensor import function_apply

# the backward kernel's largest D: bf16 in clusters of up to 16 blocks of
# 256 columns, f32 in one block
MAX_DIM = {torch.bfloat16: 4096, torch.float32: 1024}
_INTS = (torch.int32, torch.int64)
# as csrc/fused_linear_ce.cu bwd:: has them: the D columns a block owns,
# a step's vocab columns (dx) or rows (dw), the tiles of a dx cluster's
# rows and a dw cluster's vocab columns from the largest, and the floats of
# an owner's slots for the partial logits by role and tile; and the SMs a
# grid should fill
_SLICE, _STEP, _BWD_TILES, _SMS = 256, 64, (128, 64), 132
_SLOTS = {("dx", 128): 8192, ("dx", 64): 8192, ("dw", 128): 10240, ("dw", 64): 8192}


def _slots_fit(c, rows, cols, capacity):
    """Whether the partial logits of c blocks, over a rows x cols tile, fit
    an owner's slots: c rows-high slots as wide as the most 8-column units
    one block finishes."""
    return c * rows * 8 * -(-(cols // 8) // c) <= capacity


def _bwd_plan(n, d, v):
    """The split of the bf16 backward over clusters: ``(C, BM, BV)``.  C =
    ceil(d / 256) blocks a cluster, block r owning D columns [256 r, 256 r
    + 256); ceil(n / BM) dx clusters of BM rows and ceil(v / BV) dw
    clusters of BV vocab columns, each cluster over all of the other axis.

    It takes the largest tiles (BM before BV) whose partial logits fit the
    owners' slots and whose grid has at least 132 blocks, else the smallest
    tiles that fit."""
    if n < 1 or v < 1 or not 1 <= d <= MAX_DIM[torch.bfloat16]:
        raise ValueError(
            f"the backward plan takes D up to {MAX_DIM[torch.bfloat16]}, not {(n, d, v)}"
        )
    c = -(-d // _SLICE)
    fits = [(bm, bv) for bm in _BWD_TILES for bv in _BWD_TILES
            if _slots_fit(c, bm, _STEP, _SLOTS["dx", bm])
            and _slots_fit(c, _STEP, bv, _SLOTS["dw", bv])]
    for bm, bv in fits:
        if c * (-(-n // bm) + -(-v // bv)) >= _SMS:
            return c, bm, bv
    return (c, *fits[-1])


def _target_logit(logits, t):
    v = logits.shape[1]
    hit = (t >= 0) & (t < v)
    picked = logits.gather(1, t.clamp(0, v - 1).long()[:, None])[:, 0]
    return torch.where(hit, picked, 0.0)


def fused_linear_ce_plain(x, w, b, targets):
    """Plain twin of ``fused_linear_ce_fwd``: returns (loss, lse), (N,) f32."""
    logits = x.float() @ w.float() + b.float()
    lse = torch.logsumexp(logits, 1)
    return lse - _target_logit(logits, targets), lse


def fused_linear_ce_bwd_plain(x, w, b, targets, lse, g):
    """Plain twin of ``fused_linear_ce_bwd``: returns (dx, dw, db)."""
    logits = x.float() @ w.float() + b.float()
    p = torch.exp(logits - lse[:, None])
    v = logits.shape[1]
    onehot = torch.arange(v, device=x.device)[None, :] == targets[:, None]
    dl = (p - onehot.float()) * g.float()[:, None]
    dx = dl.to(w.dtype).float() @ w.float().t()
    dw = x.float().t() @ dl.to(x.dtype).float()
    return dx.to(x.dtype), dw.to(w.dtype), dl.sum(0).to(b.dtype)


def _check(x, w, b, targets):
    check("x", x, (None, None), FLOATS)
    n, d = x.shape
    check("w", w, (d, None), (x.dtype,))
    v = w.shape[1]
    check("b", b, (v,), FLOATS)
    check("targets", targets, (n,), _INTS)
    return n, d, v


def _flags(x, w, b):
    """bf16 x and w, bf16 b, and whether the rows of x and of w start 16-byte
    aligned (then the bf16 kernels stage them with 16-byte copies)."""
    d, v = w.shape
    return (int(x.dtype == torch.bfloat16), int(b.dtype == torch.bfloat16),
            int(d % 8 == 0 and x.data_ptr() % 16 == 0), int(v % 8 == 0 and w.data_ptr() % 16 == 0))


ROUTES = ("f32", "mma", "wgmma")  # the forward's kernels, by their code in the C entry
# as csrc/fused_linear_ce.cu has them: the forward's rows a block, vocab
# columns a tile by route, and most vocab splits
_FWD_ROWS, _FWD_TILE, _MAX_SPLITS = 128, {"mma": 128, "wgmma": 256}, 16


def _fwd_route(x, w):
    """The forward kernel a call takes, from dtype, shape and alignment
    alone: ``"wgmma"`` (fed by TMA) for bf16 x and w that TMA can read — D
    and V multiples of 8 and both bases 16-byte aligned (x and w are
    contiguous) — ``"mma"`` (mma.sync) for every other bf16 call, ``"f32"``
    for f32."""
    if x.dtype != torch.bfloat16:
        return "f32"
    d, v = w.shape
    if d % 8 == 0 and v % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return "wgmma"
    return "mma"


def _fwd_plan(n, v, route):
    """The bf16 forward's split of the vocabulary: ``(splits, per)``, split
    s taking vocab tiles [s·per, min((s + 1)·per, tiles)) of the route's
    width for every block of 128 rows; the f32 kernel takes (1, 1).

    ``"mma"`` (about two blocks an SM): the fewest splits that give at
    least 264 blocks, at most 16 and at most the tiles.  ``"wgmma"`` (one
    block an SM): the splits, at most 16 and at most the tiles, that
    minimise waves of 132 blocks times tiles a split, the fewest on a tie."""
    if n < 1 or v < 1 or route not in ROUTES:
        raise ValueError(f"the forward plan takes a non-empty (n, v) and a route, not "
                         f"{(n, v, route)}")
    if route == "f32":
        return 1, 1
    rb, tiles = -(-n // _FWD_ROWS), -(-v // _FWD_TILE[route])
    most = min(tiles, _MAX_SPLITS)
    if route == "mma":
        splits = min(-(-2 * _SMS // rb), most)
    else:
        splits = min(range(1, most + 1), key=lambda s: -(-rb * s // _SMS) * -(-tiles // s))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def _fwd_cost(x, w, b, targets):
    """The logits' product; x, w, b and int32 targets read, loss and lse
    written."""
    n, d = x.shape
    return 2 * n * d * w.shape[1], nbytes(x, w, b) + 4 * n + 8 * n


def _bwd_cost(x, w, b, targets, lse, g):
    """Three products (the logits again, dx, dw); x, w, b, targets, lse and
    g read, dx, dw and db written."""
    n, d = x.shape
    return 3 * 2 * n * d * w.shape[1], 2 * nbytes(x, w, b) + 12 * n


@costed(_fwd_cost)
def fused_linear_ce_fwd(x, w, b, targets):
    """Forward kernel: returns (loss, lse), both (N,) f32."""
    n, d, v = _check(x, w, b, targets)
    if not on_card(x, w, b, targets):
        return fused_linear_ce_plain(x, w, b, targets)
    route = _fwd_route(x, w)
    t = targets.to(torch.int32)
    loss = torch.empty((n,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    # the bf16 kernels' scratch: per vocab split (at most 16) and row the
    # partial max, sum-exp and target logit; per block of 128 rows a count
    part = torch.empty((3 * _MAX_SPLITS * n,), dtype=torch.float32, device=x.device)
    count = torch.zeros((-(-n // _FWD_ROWS),), dtype=torch.int32, device=x.device)
    fn = _build.c_function(
        "fused_linear_ce", "dft_flce_fwd",
        (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    )
    _, b_bf16, xvec, wvec = _flags(x, w, b)
    with on_device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), t.data_ptr(), loss.data_ptr(),
                lse.data_ptr(), part.data_ptr(), count.data_ptr(), n, d, v, ROUTES.index(route),
                b_bf16, xvec, wvec, *_fwd_plan(n, v, route), stream())
    _build.check(rc, "fused_linear_ce_fwd")
    fused_linear_ce_fwd.launches += 1
    fused_linear_ce_fwd.routes[route] += 1
    return loss, lse


fused_linear_ce_fwd.launches = 0
fused_linear_ce_fwd.routes = dict.fromkeys(ROUTES, 0)  # launches by route, never reset


@costed(_bwd_cost)
def fused_linear_ce_bwd(x, w, b, targets, lse, g):
    """Backward kernel, one launch: returns (dx, dw, db) in x's, w's and b's
    dtypes.  ``g`` is the (N,) gradient of the per-row loss."""
    n, d, v = _check(x, w, b, targets)
    check("lse", lse, (n,), (torch.float32,))
    check("g", g, (n,), FLOATS, contiguous=False)
    if not on_card(x, w, b, targets, lse, g):
        return fused_linear_ce_bwd_plain(x, w, b, targets, lse, g)
    if d > MAX_DIM[x.dtype]:
        raise ValueError(f"fused_linear_ce_bwd takes D up to {MAX_DIM[x.dtype]} in {x.dtype}, "
                         f"got {d}")
    plan = _bwd_plan(n, d, v) if x.dtype == torch.bfloat16 else (0, 0, 0)
    t = targets.to(torch.int32)
    g = g.to(torch.float32).contiguous()
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    fn = _build.c_function(
        "fused_linear_ce", "dft_flce_bwd",
        (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P),
    )
    with on_device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), t.data_ptr(), lse.data_ptr(),
                g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), n, d, v,
                *_flags(x, w, b), *plan, stream())
    _build.check(rc, "fused_linear_ce_bwd")
    fused_linear_ce_bwd.launches += 1
    return dx, dw, db


fused_linear_ce_bwd.launches = 0


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, targets):
        loss, lse = fused_linear_ce_fwd(x, w, b, targets)
        ctx.save_for_backward(x, w, b, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, targets, lse = ctx.saved_tensors
        dx, dw, db = fused_linear_ce_bwd(x, w, b, targets, lse, g)
        return dx, dw, db, None


def fused_linear_ce(x, w, b, targets):
    """Per-row cross-entropy of ``x @ w + b`` against ``targets``, (N,) f32,
    differentiable in x, w and b."""
    return function_apply(_FusedLinearCE, x, w, b, targets)
