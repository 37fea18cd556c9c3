"""Eager f32 products (counterparts of ``matmul`` and ``linear_fused`` in
``deepflows_tpu/ops/pallas_kernels.py``), both served by one tiled f32
kernel with an epilogue (``csrc/linear_f32.cu``), on the tile that
``_linear_plan`` chooses: 128 x 128 for a product whose grid of that tile
fills the card, else 32 x 32 with K split over the blocks of a cluster.

- ``matmul(a, b)``: a (M, K) @ b (K, N), f32.
- ``linear_fused(x, w, b, activation)``: act(x @ w + b), x (M, K), w
  (K, N), b (1, N) or (N,), act one of ``"none"``, ``"relu"``, ``"tanh"``.
- ``matmul_plain`` / ``linear_fused_plain``: their plain PyTorch twins.

Both products are true f32: no TF32 (the JAX kernels accumulate in f32).
The operands may be views with any strides, such as a transpose; the
output is a new contiguous (M, N) f32 tensor.  Neither wrapper records
autograd history: ``nn.functional.linear`` wraps them in
``autograd.Function``s on the ``config.use_pallas`` route.

On CPU tensors the wrappers call the plain twins; on CUDA tensors they
launch the kernel on the current stream or raise, and count the launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import I, L, P, check, on_card, on_device, stream

ACTIVATIONS = ("none", "relu", "tanh")
_F32 = (torch.float32,)
# as csrc/linear_f32.cu has them: the large tile's rows and columns, the
# small tile, its K chunks' multiple and its most splits; and the SMs a
# grid should fill
_LARGE, _LARGE_N, _SMALL, _K_STEP, _MAX_SPLITS, _SMS = 128, 128, 32, 8, 16, 132
_MIN_CHUNK = 16  # the fewest K rows a split takes


def _linear_plan(m, n, k):
    """The tiling of an (m, k) @ (k, n) product: ``(tile, chunk, splits)``,
    split s taking K rows [s·chunk, min((s + 1)·chunk, k)).  Tile 128 is
    the large tile, 128 rows x 128 columns; tile 32 the small one, a grid
    of (ceil(n / 32), ceil(m / 32), splits) blocks.

    A product whose grid of large tiles has at least 132 blocks (one an SM)
    takes that tile over all of K: ``(128, k, 1)``.  Every other takes the
    32 x 32 tile and the fewest K splits, at most 16 with chunks a multiple
    of 8 and at least 16 rows, that bring the grid to 132 blocks, or the most such
    splits when none does.  (A split of fewer rows saves less than the
    cluster's hand-over of its sums costs: K 10 split 8 + 2 ran slower
    than one block.)"""
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"the linear plan takes a non-empty product, not {(m, k, n)}")
    if -(-m // _LARGE) * -(-n // _LARGE_N) >= _SMS:
        return _LARGE, k, 1
    tiles = -(-m // _SMALL) * -(-n // _SMALL)
    for target in range(1, _MAX_SPLITS + 1):
        chunk = max(-(-k // (target * _K_STEP)) * _K_STEP, _MIN_CHUNK)
        splits = -(-k // chunk)
        if tiles * splits >= _SMS:
            break
    return _SMALL, chunk, splits


def matmul_plain(a, b):
    """Plain twin of ``matmul``."""
    return a @ b


def linear_fused_plain(x, w, b, activation: str = "none"):
    """Plain twin of ``linear_fused``: the JAX kernel's epilogue, y = acc +
    b, then ``maximum(y, 0)`` or ``tanh(y)``."""
    y = x @ w + b.reshape(1, -1)
    if activation == "relu":
        return torch.maximum(y, y.new_zeros(()))
    if activation == "tanh":
        return torch.tanh(y)
    return y


def _launch(a, b, bias, epi, what):
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = _build.c_function(
        "linear_f32", "dft_linear_f32", (P, P, P, P, I, I, I, L, L, L, L, I, I, I, I, P)
    )
    with on_device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), 0 if bias is None else bias.data_ptr(),
                out.data_ptr(), m, n, k, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                epi, *_linear_plan(m, n, k), stream())
    _build.check(rc, what)
    return out


def matmul(a, b):
    """a (M, K) @ b (K, N) in f32 on the kernel (plain twin on the CPU)."""
    check("a", a, (None, None), _F32, contiguous=False)
    check("b", b, (a.shape[1], None), _F32, contiguous=False)
    if not on_card(a, b):
        return matmul_plain(a, b)
    out = _launch(a, b, None, 0, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0


def linear_fused(x, w, b, activation: str = "none"):
    """act(x @ w + b) in f32 in one kernel (plain twin on the CPU)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    check("x", x, (None, None), _F32, contiguous=False)
    check("w", w, (x.shape[1], None), _F32, contiguous=False)
    n = w.shape[1]
    if b.numel() != n or b.dim() > 2 or (b.dim() == 2 and b.shape[0] != 1):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected (1, {n}) or ({n},)")
    check("b", b.reshape(-1), (n,), _F32)
    if not on_card(x, w, b):
        return linear_fused_plain(x, w, b, activation)
    out = _launch(x, w, b.contiguous(), 1 + ACTIVATIONS.index(activation), "linear_fused")
    linear_fused.launches += 1
    return out


linear_fused.launches = 0
