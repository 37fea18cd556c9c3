"""The Vision Transformer and its pre-norm block (counterpart of
``deepflows_tpu/models/vit.py``): a patch conv, a learned position
embedding, ``EncoderBlock``s, a final LayerNorm, mean pooling over the
tokens (no CLS token) and a Linear head."""

from __future__ import annotations

import torch

from .. import nn
from ..config import config
from ..device import Device


class EncoderBlock(nn.Module):
    """Pre-norm transformer block: x + MHA(LN(x)); x + MLP(LN(x)).
    ``remat=True`` recomputes the block in backward (``nn.remat_call``)."""

    def __init__(
        self, dim, num_heads, mlp_ratio=4.0, dropout=0.0, device=None,
        remat=False, causal=False, flash=None, ring=None,
    ):
        super().__init__()
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
        self._remat = remat

    def forward(self, x):
        if self._remat:
            return nn.remat_call(self, x, self._forward_impl)
        return self._forward_impl(x)

    def _forward_impl(self, x):
        h = self.attn(self.norm1(x))
        if self.drop is not None:
            h = self.drop(h)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.drop is not None:
            h = self.drop(h)
        return x + h


class VisionTransformer(nn.Module):
    def __init__(
        self,
        image_size=32,
        patch_size=4,
        in_channels=3,
        num_classes=10,
        dim=192,
        depth=6,
        num_heads=3,
        mlp_ratio=4.0,
        dropout=0.0,
        device=None,
        remat=False,
        flash=None,
    ):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image_size must be divisible by patch_size")
        dev = Device(device)
        self.dim = dim
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size, device=dev)
        self.pos_embed = torch.nn.Parameter(
            torch.zeros((1, n_patches, dim), device=dev, dtype=config.default_dtype))
        self.blocks = nn.Sequential(*[
            EncoderBlock(dim, num_heads, mlp_ratio, dropout, device=dev, remat=remat,
                         flash=flash)
            for _ in range(depth)
        ])
        self.norm = nn.LayerNorm(dim, device=dev)
        self.head = nn.Linear(dim, num_classes, device=dev)

    def forward(self, x):
        B = x.shape[0]
        p = self.patch_embed(x).reshape(B, self.dim, -1).transpose(1, 2)  # (B, N, dim)
        p = self.norm(self.blocks(p + self.pos_embed))
        return self.head(p.mean(1))


def ViT_Tiny(image_size=32, patch_size=4, num_classes=10, device=None, dropout=0.0,
             remat=False, flash=None):
    return VisionTransformer(image_size, patch_size, 3, num_classes, dim=192, depth=6,
                             num_heads=3, device=device, dropout=dropout, remat=remat,
                             flash=flash)
