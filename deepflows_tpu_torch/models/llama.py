"""Llama-family decoder-only LM (counterpart of ``deepflows_tpu/models/llama.py``):
RMSNorm, rotary positions (RoPE), grouped-query attention (GQA), an optional
sliding window and a SwiGLU MLP, every Linear bias-free in the ``(in, out)``
layout.  ``models.KVCacheDecoder(lm)`` serves it through
``LlamaKVCacheDecoder``."""

from __future__ import annotations

from .. import nn
from ..device import Device
from .transformer_lm import _pad_greedy_generate


class LlamaBlock(nn.Module):
    """Pre-norm block: x + Attn(RMSNorm(x)); x + SwiGLU(RMSNorm(x)), the
    SwiGLU MLP ``down(silu(gate(x)) * up(x))`` of width ``hidden``."""

    def __init__(
        self, dim, num_heads, num_kv_heads, hidden, device=None,
        remat=False, flash=None, rope_theta=10000.0, window=None,
    ):
        super().__init__()
        self.norm1 = nn.RMSNorm(dim, device=device)
        self.attn = nn.MultiheadAttention(
            dim, num_heads, bias=False, causal=True, device=device,
            flash=flash, num_kv_heads=num_kv_heads, rope=True,
            rope_theta=rope_theta, window=window,
        )
        self.norm2 = nn.RMSNorm(dim, device=device)
        self.gate = nn.Linear(dim, hidden, bias=False, device=device)
        self.up = nn.Linear(dim, hidden, bias=False, device=device)
        self.down = nn.Linear(hidden, dim, bias=False, device=device)
        self.act = nn.SiLU()
        self._remat = remat

    def forward(self, x):
        if self._remat:
            return nn.remat_call(self, x, self._forward_impl)
        return self._forward_impl(x)

    def _forward_impl(self, x):
        x = x + self.attn(self.norm1(x))
        h = self.norm2(x)
        return x + self.down(self.act(self.gate(h)) * self.up(h))


class _DecoderLM(nn.Module):
    """What ``LlamaLM`` and ``MixtralLM`` share: the token embedding, made
    here; the blocks, which the subclass makes; a final RMSNorm and a
    bias-free head (``_add_head``)."""

    def __init__(self, vocab_size, max_len, dim, num_heads, num_kv_heads, device):
        super().__init__()
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.num_heads = num_heads
        self.num_kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        self.tok_embed = nn.Embedding(vocab_size, dim, device=device)

    def _add_head(self, dim, device):
        self.norm = nn.RMSNorm(dim, device=device)
        self.head = nn.Linear(dim, self.vocab_size, bias=False, device=device)

    def forward(self, idx):
        # idx: (B, L) int tokens -> (B, L, vocab) logits
        x = self.tok_embed(idx)
        if x.shape[1] > self.max_len:
            raise ValueError(
                f"sequence length {x.shape[1]} > max_len {self.max_len}"
            )
        return self.head(self.norm(self.blocks(x)))

    def generate(self, idx, new_tokens: int):
        """Greedy decoding by full forwards, each context right-padded to
        ``max_len``: the oracle of ``models.KVCacheDecoder``, which is the
        serving path."""
        return _pad_greedy_generate(self, idx, new_tokens)


class LlamaLM(_DecoderLM):
    def __init__(
        self,
        vocab_size: int,
        max_len: int = 128,
        dim: int = 128,
        depth: int = 4,
        num_heads: int = 4,
        num_kv_heads=None,
        mlp_ratio: float = 8 / 3,
        rope_theta: float = 10000.0,
        device=None,
        remat: bool = False,
        flash=None,
        window=None,
    ):
        dev = Device(device)
        super().__init__(vocab_size, max_len, dim, num_heads, num_kv_heads, dev)
        hidden = int(dim * mlp_ratio)
        self.blocks = nn.Sequential(*[
            LlamaBlock(
                dim, num_heads, self.num_kv_heads, hidden, device=dev,
                remat=remat, flash=flash, rope_theta=rope_theta, window=window,
            )
            for _ in range(depth)
        ])
        self._add_head(dim, dev)
