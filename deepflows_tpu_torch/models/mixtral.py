"""Mixtral-style sparse-MoE decoder LM (counterpart of
``deepflows_tpu/models/mixtral.py``): the Llama attention recipe (RMSNorm,
RoPE, GQA) with a top-k-routed mixture of SwiGLU experts as the FFN.  Train
it with ``nn.MoECriterion`` around the task loss; ``models.KVCacheDecoder(lm)``
serves it through ``MixtralKVCacheDecoder``."""

from __future__ import annotations

from .. import nn
from ..device import Device
from .llama import _DecoderLM


class MixtralBlock(nn.Module):
    """Pre-norm block: x + GQA-Attn(RMSNorm(x)); x + MoE(RMSNorm(x)), top-k
    renormalised routing over SwiGLU experts."""

    def __init__(
        self, dim, num_heads, num_kv_heads, hidden, n_experts, top_k,
        device=None, remat=False, flash=None, rope_theta=10000.0,
    ):
        super().__init__()
        self.norm1 = nn.RMSNorm(dim, device=device)
        self.attn = nn.MultiheadAttention(
            dim, num_heads, bias=False, causal=True, device=device,
            flash=flash, num_kv_heads=num_kv_heads, rope=True,
            rope_theta=rope_theta,
        )
        self.norm2 = nn.RMSNorm(dim, device=device)
        self.moe = nn.MoE(
            dim, hidden, n_experts, top_k=top_k, swiglu=True, device=device
        )
        self._remat = remat

    def forward(self, x):
        if self._remat:
            return nn.remat_call(self, x, self._forward_impl)
        return self._forward_impl(x)

    def _forward_impl(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.moe(self.norm2(x))


class MixtralLM(_DecoderLM):
    def __init__(
        self,
        vocab_size: int,
        max_len: int = 128,
        dim: int = 128,
        depth: int = 4,
        num_heads: int = 4,
        num_kv_heads=None,
        n_experts: int = 8,
        top_k: int = 2,
        mlp_ratio: float = 8 / 3,
        rope_theta: float = 10000.0,
        device=None,
        remat: bool = False,
        flash=None,
    ):
        dev = Device(device)
        super().__init__(vocab_size, max_len, dim, num_heads, num_kv_heads, dev)
        self.n_experts = n_experts
        self.top_k = top_k
        hidden = int(dim * mlp_ratio)
        self.blocks = nn.Sequential(*[
            MixtralBlock(
                dim, num_heads, self.num_kv_heads, hidden, n_experts, top_k,
                device=dev, remat=remat, flash=flash, rope_theta=rope_theta,
            )
            for _ in range(depth)
        ])
        self._add_head(dim, dev)
