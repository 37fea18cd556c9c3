"""The pre-norm transformer block (counterpart of ``EncoderBlock`` in
``deepflows_tpu/models/vit.py``; ``VisionTransformer`` needs ``Conv2d`` and
comes with the CNN slice)."""

from __future__ import annotations

from .. import nn


class EncoderBlock(nn.Module):
    """Pre-norm transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(
        self, dim, num_heads, mlp_ratio=4.0, dropout=0.0, device=None,
        remat=False, causal=False, flash=None, ring=None,
    ):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "remat is not ported yet"
            )
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = nn.MultiheadAttention(
            dim, num_heads, dropout=dropout, causal=causal, device=device,
            flash=flash, ring=ring,
        )
        self.norm2 = nn.LayerNorm(dim, device=device)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(
            nn.Linear(dim, hidden, device=device),
            nn.GELU(),
            nn.Linear(hidden, dim, device=device),
        )
        self.drop = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x):
        h = self.attn(self.norm1(x))
        if self.drop is not None:
            h = self.drop(h)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.drop is not None:
            h = self.drop(h)
        return x + h
