"""Multi-head attention (counterpart of ``deepflows_tpu/nn/modules/attention.py``):
the naive path and the flash route, with grouped-query attention (GQA),
rotary positions (RoPE) and a sliding window.

Naive path: scores are one batched matmul scaled by ``1/√D``; the causal
mask is an additive ``-1e9`` built in the scores' dtype, and a ``window``
adds ``-1e9`` below the band (key j is visible from query i while
``i - j < window``); the softmax is the JAX tape's
(``nn.functional.softmax``).  With ``num_kv_heads < num_heads`` each group
of ``num_heads // num_kv_heads`` query heads reads one K/V head through
5-D broadcast products, K and V never repeated.

Flash route (``ops.flash_attention``: the CUDA kernel on the card, its
plain twin on the CPU), chosen as the JAX package's ``_use_flash`` chooses:
``need_weights`` or live attention dropout in training take the naive path;
otherwise ``flash=True`` forces the route, ``flash=False`` refuses it, and
``flash=None`` takes it on the card from ``q_len >= 512``, the counterpart
of the JAX package's "on a real TPU".  The kernel takes equal head
counts, so under GQA K and V are repeated to ``num_heads`` heads first (a
copy; autograd sums their gradients back per group, as the JAX package's
ones-multiply does); the window goes to the kernel.

RoPE is the NeoX half rotation ``x·cos + rotate_half(x)·sin`` on q and k
after the head split, its tables built in float64 numpy, cast to x's
dtype and applied in that dtype, as in the JAX package.

``ring=(mesh, seq_axis[, batch_axis])`` sends self-attention with equal
head counts, without ``need_weights`` and without live attention dropout
to ``parallel.ring_attention`` over the mesh axis ``seq_axis`` (batch axis
``"data"`` unless named), as the JAX package chooses it; other calls take
the routes above.  A window is refused with a ring.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.flash_attention import flash_attention
from .. import functional as F
from .dropout import Dropout
from .linear import Linear
from .module import Module


class MultiheadAttention(Module):
    """Batch-first multi-head attention on ``(B, L, E)`` inputs.

    ``forward(query, key=None, value=None, need_weights=False)`` defaults to
    self-attention and returns the output, or ``(output, weights)`` with the
    pre-dropout weights averaged over heads when ``need_weights``."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        bias: bool = True,
        causal: bool = False,
        device=None,
        flash=None,
        ring=None,
        num_kv_heads=None,
        rope: bool = False,
        rope_theta: float = 10000.0,
        window=None,
    ) -> None:
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} not divisible by num_heads {num_heads}"
            )
        if num_kv_heads is None:
            num_kv_heads = num_heads
        if num_heads % num_kv_heads:
            raise ValueError(
                f"num_heads {num_heads} not divisible by num_kv_heads "
                f"{num_kv_heads}"
            )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = embed_dim // num_heads
        if rope and self.head_dim % 2:
            raise ValueError("rope needs an even head_dim")
        if window is not None:
            if not causal:
                raise ValueError("window requires causal=True")
            if int(window) < 1:
                raise ValueError("window must be >= 1")
            if ring is not None:
                raise ValueError("window is not supported with ring attention")
        kv_dim = num_kv_heads * self.head_dim
        self.q_proj = Linear(embed_dim, embed_dim, bias=bias, device=device)
        self.k_proj = Linear(embed_dim, kv_dim, bias=bias, device=device)
        self.v_proj = Linear(embed_dim, kv_dim, bias=bias, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, bias=bias, device=device)
        self.rope = bool(rope)
        self.rope_theta = float(rope_theta)
        self.attn_drop = Dropout(dropout) if dropout > 0 else None
        self.causal = causal
        self.window = None if window is None else int(window)
        self.flash = flash
        self.ring = tuple(ring) if ring is not None else None
        self._mask_cache = {}
        self._rope_cache = {}

    # the JAX package's crossover of its auto mode (FLASH_AUTO_MIN_LEN)
    FLASH_AUTO_MIN_LEN = 512

    def _use_ring(self, need_weights: bool, is_self: bool) -> bool:
        if self.ring is None or not is_self or self.num_kv_heads != self.num_heads:
            return False
        if need_weights:
            return False
        return not (self.attn_drop is not None and self.training)

    def _use_flash(self, need_weights: bool, q_len: int) -> bool:
        if need_weights:
            return False  # flash never materialises the weights
        if self.attn_drop is not None and self.training:
            return False  # attention dropout needs the materialised softmax
        if self.flash is None:
            return self.q_proj.weight.is_cuda and q_len >= self.FLASH_AUTO_MIN_LEN
        return bool(self.flash)

    def forward(self, query, key=None, value=None, need_weights: bool = False):
        is_self = key is None and value is None
        key = query if key is None else key
        value = key if value is None else value
        B, L, E = query.shape
        Lk = key.shape[1]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim

        def split(x, length, heads):
            # (B, length, heads*D) -> (B, heads, length, D)
            return x.reshape(B, length, heads, D).transpose(1, 2)

        q = split(self.q_proj(query), L, H)
        k = split(self.k_proj(key), Lk, Hkv)
        v = split(self.v_proj(value), Lk, Hkv)
        if self.rope:
            q = self._apply_rope(q, L)
            k = self._apply_rope(k, Lk)
        if self._use_ring(need_weights, is_self):
            from ...parallel.ring import ring_attention

            mesh, seq_axis = self.ring[0], self.ring[1]
            batch_axis = self.ring[2] if len(self.ring) > 2 else "data"
            out = ring_attention(q, k, v, mesh, seq_axis, causal=self.causal,
                                 batch_axis=batch_axis)  # (B, H, L, D)
            return self.out_proj(out.transpose(1, 2).reshape(B, L, E))
        if self._use_flash(need_weights, L):
            if Hkv != H:  # the kernel takes equal head counts: repeat K/V
                k, v = (t.reshape(B, Hkv, 1, Lk, D).expand(B, Hkv, H // Hkv, Lk, D)
                        .reshape(B, H, Lk, D) for t in (k, v))
            out = flash_attention(q, k, v, self.causal, None, self.window)  # (B, H, L, D)
            return self.out_proj(out.transpose(1, 2).reshape(B, L, E))
        # grouped products: (B, Hkv, G, L, D) against (B, Hkv, 1, Lk, D);
        # with G = 1 the ordinary per-head products
        G = H // Hkv
        q = q.reshape(B, Hkv, G, L, D)
        k = k.reshape(B, Hkv, 1, Lk, D)
        v = v.reshape(B, Hkv, 1, Lk, D)
        scores = (q @ k.transpose(3, 4)) * (1.0 / math.sqrt(D))
        if self.causal:
            scores = scores + self._causal_mask(L, Lk, scores)
        attn = F.softmax(scores, 4)
        weights = attn.reshape(B, H, L, Lk).mean(1) if need_weights else None
        if self.attn_drop is not None:
            attn = self.attn_drop(attn)
        out = (attn @ v).reshape(B, H, L, D).transpose(1, 2).reshape(B, L, E)
        out = self.out_proj(out)
        if need_weights:
            return out, weights
        return out

    def _apply_rope(self, x, L):
        """Rotary position embedding, NeoX half-rotation layout:
        ``x·cos + rotate_half(x)·sin`` at angles ``pos / rope_theta **
        (2i / D)``; the (L, D) tables are built in float64 numpy, cast to
        f32 and then to x's dtype, and cached per (L, dtype, device)."""
        key = (L, x.dtype, x.device)
        cs = self._rope_cache.get(key)
        if cs is None:
            cos, sin = rope_tables(L, self.head_dim, self.rope_theta)
            cs = tuple(t.to(device=x.device, dtype=x.dtype) for t in (cos, sin))
            self._rope_cache[key] = cs
        cos, sin = cs
        half = self.head_dim // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos + rot * sin

    def _causal_mask(self, L, Lk, scores):
        """Additive ``-1e9`` above the diagonal and, with a window, on and
        below its lower edge (key j hidden from query i once ``i - j >=
        window``), in the scores' dtype, cached per (L, Lk, dtype,
        device)."""
        key = (L, Lk, scores.dtype, scores.device)
        mask = self._mask_cache.get(key)
        if mask is None:
            full = torch.full((L, Lk), -1e9, dtype=torch.float32)
            mask = torch.triu(full, diagonal=1)
            if self.window is not None:
                mask = mask + torch.tril(full, diagonal=-self.window)
            mask = mask.to(device=scores.device, dtype=scores.dtype)
            self._mask_cache[key] = mask
        return mask


def rope_tables(n_pos: int, head_dim: int, theta: float):
    """The (n_pos, head_dim) f32 cos and sin tables of RoPE's NeoX layout
    (each half-width table repeated twice), built in float64 numpy as the
    JAX package builds them."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2.0 / head_dim))
    ang = np.outer(np.arange(n_pos, dtype=np.float64), inv)
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    return torch.from_numpy(cos), torch.from_numpy(sin)
