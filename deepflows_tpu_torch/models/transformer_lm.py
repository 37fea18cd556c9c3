"""Decoder-only transformer language model (counterpart of
``deepflows_tpu/models/transformer_lm.py``): token Embedding plus a learned
position Parameter, causal ``EncoderBlock`` × depth, a final LayerNorm and
a Linear head.  ``trunk()`` is the model half of the fused-head training
pair, ``pipeline_partition()`` splits the model into pipeline stages."""

from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..config import config
from ..device import Device
from .vit import EncoderBlock


def _pad_greedy_generate(model, idx, new_tokens: int):
    """Greedy decoding by full forwards: append ``new_tokens`` tokens to the
    (B, L) int prompt, right-padding each context to ``max_len`` as the JAX
    package does (causal masking makes the pad inert)."""
    was_training = model.training
    model.eval()
    try:
        idx = np.asarray(idx)
        for _ in range(new_tokens):
            L = idx.shape[1]
            if L >= model.max_len:
                ctx = idx[:, -model.max_len:]
                pos = model.max_len - 1
            else:
                pad = np.zeros((idx.shape[0], model.max_len - L), idx.dtype)
                ctx = np.concatenate([idx, pad], 1)
                pos = L - 1
            with torch.no_grad():
                logits = model(torch.as_tensor(ctx, dtype=torch.long))
            nxt = logits[:, pos].argmax(-1).cpu().numpy()
            idx = np.concatenate([idx, nxt[:, None].astype(idx.dtype)], 1)
        return idx
    finally:
        if was_training:
            model.train()


def _embed(tok_embed, pos_embed, idx):
    """Token + position embedding, (B, L) -> (B, L, D)."""
    x = tok_embed(idx)
    L, max_len = x.shape[1], pos_embed.shape[1]
    if L > max_len:
        raise ValueError(f"sequence length {L} > max_len {max_len}")
    return x + pos_embed[:, :L]


class _LMPre(nn.Module):
    """Pipeline pre-stage: token + position embedding, (B, L) -> (B, L, D)."""

    def __init__(self, tok_embed, pos_embed):
        super().__init__()
        self.tok_embed = tok_embed
        self.pos_embed = pos_embed

    def forward(self, idx):
        return _embed(self.tok_embed, self.pos_embed, idx)


class _LMPost(nn.Module):
    """Pipeline post-stage: final LayerNorm + LM head, (B, L, D) -> logits."""

    def __init__(self, norm, head):
        super().__init__()
        self.norm = norm
        self.head = head

    def forward(self, x):
        return self.head(self.norm(x))


class _LMTrunk(nn.Module):
    """The LM without its head: (B, L) tokens -> (B, L, D) hidden states.
    It wraps (shares) the parent LM, so its parameters are the LM's under
    an ``lm.`` prefix and an optimizer built on ``lm.parameters()`` maps
    onto it by identity; ``lm(idx)`` still gives logits."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, idx):
        return self.lm._hidden(idx)


class TransformerLM(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        max_len: int = 128,
        dim: int = 128,
        depth: int = 4,
        num_heads: int = 4,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        device=None,
        remat: bool = False,
        flash=None,
        ring=None,
    ):
        super().__init__()
        dev = Device(device)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.tok_embed = nn.Embedding(vocab_size, dim, device=dev)
        self.pos_embed = torch.nn.Parameter(
            torch.zeros((1, max_len, dim), device=dev, dtype=config.default_dtype)
        )
        self.blocks = nn.Sequential(
            *[
                EncoderBlock(
                    dim, num_heads, mlp_ratio, dropout, device=dev,
                    remat=remat, causal=True, flash=flash, ring=ring,
                )
                for _ in range(depth)
            ]
        )
        self.norm = nn.LayerNorm(dim, device=dev)
        self.head = nn.Linear(dim, vocab_size, device=dev)

    def _hidden(self, idx):
        # idx: (B, L) int tokens -> (B, L, D) normed hidden states
        return self.norm(self.blocks(_embed(self.tok_embed, self.pos_embed, idx)))

    def forward(self, idx):
        # idx: (B, L) int tokens -> (B, L, vocab) logits
        return self.head(self._hidden(idx))

    def generate(self, idx, new_tokens: int):
        """Greedy autoregressive decoding by full forwards: append
        ``new_tokens`` tokens to the (B, L) int prompt (a numpy array).
        ``models.KVCacheDecoder`` is the serving path."""
        return _pad_greedy_generate(self, idx, new_tokens)

    def trunk(self):
        """A shared-parameter view of this LM that stops before the head:
        ``CompiledTrainStep(lm.trunk(), opt, nn.LMHeadCrossEntropy(lm.head))``."""
        return _LMTrunk(self)

    def pipeline_partition(self):
        """``(pre, blocks, post)``: the embeddings, the list of blocks and the
        final LayerNorm + head, each sharing this model's parameters."""
        return (
            _LMPre(self.tok_embed, self.pos_embed),
            list(self.blocks),
            _LMPost(self.norm, self.head),
        )
