"""Multi-head attention (counterpart of ``deepflows_tpu/nn/modules/attention.py``):
the naive path and the flash route.

Naive path: scores are one batched matmul scaled by ``1/√D``; the causal
mask is an additive ``-1e9`` built in the scores' dtype; the softmax is the
JAX tape's (``nn.functional.softmax``).

Flash route (``ops.flash_attention``: the CUDA kernel on the card, its
plain twin on the CPU), chosen as the JAX package's ``_use_flash`` chooses:
``need_weights`` or live attention dropout in training take the naive path;
otherwise ``flash=True`` forces the route, ``flash=False`` refuses it, and
``flash=None`` takes it on the card from ``q_len >= 512``, the counterpart
of the JAX package's "on a real TPU".

The routes that later slices port raise ``NotImplementedError``: ``ring``
(the parallel slice), ``num_kv_heads != num_heads``, ``rope`` and
``window`` (the Llama and Mixtral slice).
"""

from __future__ import annotations

import math

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
        if ring is not None:
            raise NotImplementedError(
                "ring attention is ported with the parallel slice"
            )
        if num_kv_heads is not None and num_kv_heads != num_heads:
            raise NotImplementedError(
                "grouped-query attention (num_kv_heads != num_heads) is ported "
                "with the Llama/Mixtral slice"
            )
        if rope:
            raise NotImplementedError(
                "rope is ported with the Llama/Mixtral slice"
            )
        if window is not None:
            raise NotImplementedError(
                "sliding-window attention is ported with the Llama/Mixtral slice"
            )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = Linear(embed_dim, embed_dim, bias=bias, device=device)
        self.k_proj = Linear(embed_dim, embed_dim, bias=bias, device=device)
        self.v_proj = Linear(embed_dim, embed_dim, bias=bias, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, bias=bias, device=device)
        self.attn_drop = Dropout(dropout) if dropout > 0 else None
        self.causal = causal
        self.flash = flash
        self._mask_cache = {}

    # the JAX package's crossover of its auto mode (FLASH_AUTO_MIN_LEN)
    FLASH_AUTO_MIN_LEN = 512

    def _use_flash(self, need_weights: bool, q_len: int) -> bool:
        if need_weights:
            return False  # flash never materialises the weights
        if self.attn_drop is not None and self.training:
            return False  # attention dropout needs the materialised softmax
        if self.flash is None:
            return self.q_proj.weight.is_cuda and q_len >= self.FLASH_AUTO_MIN_LEN
        return bool(self.flash)

    def forward(self, query, key=None, value=None, need_weights: bool = False):
        key = query if key is None else key
        value = key if value is None else value
        B, L, E = query.shape
        Lk = key.shape[1]
        H, D = self.num_heads, self.head_dim

        def split(x, length):
            # (B, length, H*D) -> (B, H, length, D)
            return x.reshape(B, length, H, D).transpose(1, 2)

        q = split(self.q_proj(query), L)
        k = split(self.k_proj(key), Lk)
        v = split(self.v_proj(value), Lk)
        if self._use_flash(need_weights, L):
            out = flash_attention(q, k, v, self.causal)  # (B, H, L, D)
            return self.out_proj(out.transpose(1, 2).reshape(B, L, E))
        scores = (q @ k.transpose(2, 3)) * (1.0 / math.sqrt(D))
        if self.causal:
            scores = scores + self._causal_mask(L, Lk, scores)
        attn = F.softmax(scores, 3)
        weights = attn.mean(1) if need_weights else None
        if self.attn_drop is not None:
            attn = self.attn_drop(attn)
        out = (attn @ v).transpose(1, 2).reshape(B, L, E)
        out = self.out_proj(out)
        if need_weights:
            return out, weights
        return out

    def _causal_mask(self, L, Lk, scores):
        """Additive ``-1e9`` above the diagonal in the scores' dtype, cached
        per (L, Lk, dtype, device)."""
        key = (L, Lk, scores.dtype, scores.device)
        mask = self._mask_cache.get(key)
        if mask is None:
            mask = torch.triu(
                torch.full((L, Lk), -1e9, dtype=torch.float32), diagonal=1
            ).to(device=scores.device, dtype=scores.dtype)
            self._mask_cache[key] = mask
        return mask
