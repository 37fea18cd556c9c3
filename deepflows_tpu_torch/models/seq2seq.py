"""The encoder-decoder transformer and its greedy generator (counterpart of
``deepflows_tpu/models/seq2seq.py``).

``Seq2SeqTransformer`` is a bidirectional encoder of ``vit.EncoderBlock``s
and a causal decoder of ``CrossDecoderBlock``s that cross-attend to the
encoder's memory, with one token table shared by source and target,
learned positions (``src_pos``, ``tgt_pos``, zeros at init) and an untied
head.  ``forward`` takes the concatenated ``(B, src_len + tgt_len)``
batch and splits it at ``src_len``, so ``jit.CompiledTrainStep`` trains
it with ``nn.CrossEntropyLoss`` on the target ids.  Attention is the
naive path everywhere (``flash=False``, as in the JAX package).

``Seq2SeqGenerator`` encodes once, computes every decoder layer's cross
K/V once, then decodes greedily against a static ``(layers, B, H,
tgt_len, Dh)`` self-attention cache.  Where JAX runs the decode as one
``lax.scan`` program, the port captures one step in a CUDA graph on the
card (``jit.StepGraphs``) and replays it once a token: the position is a
0-d tensor on the device, the cache is written by ``index_copy_``, and the
step reads no host value.  On CPU tensors the same step runs eagerly.
"""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace

import numpy as np
import torch

from .. import nn
from ..config import config
from ..device import Device
from ..jit import StepGraphs
from ..nn.lora import assert_no_unmerged_lora
from .decoding import KVCacheDecoder, _clone, _copy_into
from .vit import EncoderBlock


class CrossDecoderBlock(nn.Module):
    """Pre-norm decoder block: x + SelfAttn(LN(x)) [causal]; x +
    CrossAttn(LN(x), memory); x + MLP(LN(x))."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, dropout=0.0, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.self_attn = nn.MultiheadAttention(
            dim, num_heads, dropout=dropout, causal=True, device=device, flash=False)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.cross_attn = nn.MultiheadAttention(
            dim, num_heads, dropout=dropout, causal=False, device=device, flash=False)
        self.norm3 = nn.LayerNorm(dim, device=device)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(
            nn.Linear(dim, hidden, device=device),
            nn.GELU(),
            nn.Linear(hidden, dim, device=device),
        )
        self.drop = nn.Dropout(dropout) if dropout > 0 else None

    def _dropped(self, h):
        return h if self.drop is None else self.drop(h)

    def forward(self, x, memory):
        x = x + self._dropped(self.self_attn(self.norm1(x)))
        x = x + self._dropped(self.cross_attn(self.norm2(x), memory, memory))
        return x + self._dropped(self.mlp(self.norm3(x)))


class Seq2SeqTransformer(nn.Module):
    """``forward(x)`` with ``x = concat([src, tgt_in], 1)`` (int tokens,
    split at ``src_len``) returns (B, tgt_len, vocab) logits; train with
    teacher forcing (``tgt_in`` the BOS-shifted target) and
    ``nn.CrossEntropyLoss`` on the (B, tgt_len) target ids."""

    def __init__(
        self,
        vocab_size: int,
        src_len: int = 32,
        tgt_len: int = 32,
        dim: int = 128,
        enc_depth: int = 2,
        dec_depth: int = 2,
        num_heads: int = 4,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        device=None,
    ):
        super().__init__()
        dev = Device(device)
        self.vocab_size = vocab_size
        self.src_len = src_len
        self.tgt_len = tgt_len
        self.tok_embed = nn.Embedding(vocab_size, dim, device=dev)  # shared by both sides
        kw = dict(device=dev, dtype=config.default_dtype)
        self.src_pos = nn.Parameter(torch.zeros((1, src_len, dim), **kw))
        self.tgt_pos = nn.Parameter(torch.zeros((1, tgt_len, dim), **kw))
        self.enc_blocks = nn.ModuleList([
            EncoderBlock(dim, num_heads, mlp_ratio, dropout, device=dev, causal=False,
                         flash=False)
            for _ in range(enc_depth)
        ])
        self.enc_norm = nn.LayerNorm(dim, device=dev)
        self.dec_blocks = nn.ModuleList([
            CrossDecoderBlock(dim, num_heads, mlp_ratio, dropout, device=dev)
            for _ in range(dec_depth)
        ])
        self.norm = nn.LayerNorm(dim, device=dev)
        self.head = nn.Linear(dim, vocab_size, device=dev)

    def encode(self, src):
        """(B, Ls) int -> (B, Ls, D) memory."""
        Ls = src.shape[1]
        if Ls > self.src_len:
            raise ValueError(f"source length {Ls} > src_len {self.src_len}")
        x = self.tok_embed(src) + self.src_pos[:, :Ls]
        for blk in self.enc_blocks:
            x = blk(x)
        return self.enc_norm(x)

    def decode(self, tgt_in, memory):
        """(B, Lt) int + (B, Ls, D) memory -> (B, Lt, vocab) logits."""
        Lt = tgt_in.shape[1]
        if Lt > self.tgt_len:
            raise ValueError(f"target length {Lt} > tgt_len {self.tgt_len}")
        x = self.tok_embed(tgt_in) + self.tgt_pos[:, :Lt]
        for blk in self.dec_blocks:
            x = blk(x, memory)
        return self.head(self.norm(x))

    def forward(self, x):
        x = torch.as_tensor(x, device=self.head.weight.device)
        return self.decode(x[:, self.src_len:], self.encode(x[:, :self.src_len]))

    def generate(self, src, new_tokens: int, bos_id: int = 0):
        """Greedy decode: (B, Ls) source -> (B, new_tokens) numpy target ids
        (BOS not included), through a ``Seq2SeqGenerator`` kept on the
        model."""
        gen = getattr(self, "_generator", None)
        if gen is None:
            gen = self._generator = Seq2SeqGenerator(self)
        return gen.generate(src, new_tokens, bos_id=bos_id)


class Seq2SeqGenerator:
    """KV-cache greedy generation for ``Seq2SeqTransformer``.

    ``generate`` prepares the weights once (cast to ``compute_dtype``, so
    live updates are read), encodes the source and computes each decoder
    layer's cross K/V, then runs ``new_tokens`` steps of one captured
    decode step.  LayerNorm statistics, the softmax and the logits are f32
    (the ``KVCacheDecoder`` conventions: ``_ln``, the head widened to f32).
    One graph per ``(B, Ls, new_tokens, dtype)``; one host readback per
    generate.  A generator serves one generate at a time."""

    def __init__(self, model: Seq2SeqTransformer, compute_dtype=None):
        assert_no_unmerged_lora(model, "Seq2SeqGenerator")
        self.model = model
        self.compute_dtype = compute_dtype
        self._params = None  # the prepared weights every step reads
        self._loops = {}  # graph key -> the tensors and the step of its loop
        self._graphs = StepGraphs()
        self._lock = threading.Lock()
        self._capture = True  # False runs the eager loop on the card too

    # ------------------------------------------------------------ params
    def _gather(self):
        """The model's parameter tensors, detached, in the JAX tree's
        layout."""
        m = self.model

        def attn(a, pre):
            return {f"{pre}q_w": a.q_proj.weight, f"{pre}q_b": a.q_proj.bias,
                    f"{pre}k_w": a.k_proj.weight, f"{pre}k_b": a.k_proj.bias,
                    f"{pre}v_w": a.v_proj.weight, f"{pre}v_b": a.v_proj.bias,
                    f"{pre}o_w": a.out_proj.weight, f"{pre}o_b": a.out_proj.bias}

        def block(blk, norms, attns):
            d = dict(fc1_w=blk.mlp[0].weight, fc1_b=blk.mlp[0].bias,
                     fc2_w=blk.mlp[2].weight, fc2_b=blk.mlp[2].bias)
            for i, norm in enumerate(norms, 1):
                d[f"ln{i}_w"], d[f"ln{i}_b"] = norm.weight, norm.bias
            for a, pre in attns:
                d.update(attn(a, pre))
            return {k: t.detach() for k, t in d.items()}

        return dict(
            tok=m.tok_embed.weight.detach(),
            src_pos=m.src_pos.detach(),
            tgt_pos=m.tgt_pos.detach(),
            enc=[block(b, (b.norm1, b.norm2), ((b.attn, ""),)) for b in m.enc_blocks],
            dec=[block(b, (b.norm1, b.norm2, b.norm3),
                       ((b.self_attn, "s_"), (b.cross_attn, "c_"))) for b in m.dec_blocks],
            enc_lnf_w=m.enc_norm.weight.detach(), enc_lnf_b=m.enc_norm.bias.detach(),
            lnf_w=m.norm.weight.detach(), lnf_b=m.norm.bias.detach(),
            head_w=m.head.weight.detach(), head_b=m.head.bias.detach(),
        )

    def _cast(self, a):
        if self.compute_dtype is not None and a.is_floating_point():
            return a.to(self.compute_dtype)
        return a

    def _prepared(self):
        """The model's current weights cast into the tensors every captured
        step reads (cloned at the first call, since a cast may return the
        model's own tensor; copied into afterwards)."""
        tree = self._gather()
        fresh = {k: [{n: self._cast(t) for n, t in b.items()} for b in v]
                 if isinstance(v, list) else self._cast(v) for k, v in tree.items()}
        if self._params is None:
            self._params = _clone(fresh)
        else:
            _copy_into(self._params, fresh)
        return self._params

    # ------------------------------------------------------- pure pieces
    _ln = staticmethod(KVCacheDecoder._ln)
    _scores = staticmethod(KVCacheDecoder._scores)
    _mlp = staticmethod(KVCacheDecoder._mlp)

    def _dims(self):
        a = self.model.enc_blocks[0].attn
        return a.num_heads, a.head_dim

    @staticmethod
    def _heads(x, w, b, H):
        B, L, _ = x.shape
        return (x @ w + b).reshape(B, L, H, -1).transpose(1, 2)  # (B, H, L, Dh)

    def _attend(self, q, k, v, scale, invalid=None):
        """softmax(q kᵀ · scale) v with f32 scores and softmax, (B, H, T,
        Dh) -> (B, T, H·Dh)."""
        s = self._scores(q, k, scale)
        if invalid is not None:
            s = s.masked_fill(invalid, -1e30)
        o = torch.softmax(s, -1).to(v.dtype) @ v
        B, H, T, Dh = o.shape
        return o.transpose(1, 2).reshape(B, T, H * Dh)

    def _encode_cross(self, params, src):
        """The encoder's forward and each decoder layer's cross K/V: src (B,
        Ls) -> (cross_k, cross_v), each (dec_layers, B, H, Ls, Dh)."""
        H, Dh = self._dims()
        scale = 1.0 / math.sqrt(Dh)
        x = params["tok"][src] + params["src_pos"][:, :src.shape[1]]
        for p in params["enc"]:
            h = self._ln(x, p["ln1_w"], p["ln1_b"])
            o = self._attend(*(self._heads(h, p[f"{n}_w"], p[f"{n}_b"], H) for n in "qkv"),
                             scale)
            x = x + (o @ p["o_w"] + p["o_b"])
            x = x + self._mlp(self._ln(x, p["ln2_w"], p["ln2_b"]), p)
        mem = self._ln(x, params["enc_lnf_w"], params["enc_lnf_b"])
        ck = torch.stack([self._heads(mem, p["c_k_w"], p["c_k_b"], H) for p in params["dec"]])
        cv = torch.stack([self._heads(mem, p["c_v_w"], p["c_v_b"], H) for p in params["dec"]])
        return ck, cv

    def _forward_one(self, params, lp, tok):
        """One decode step for tokens (B,) at position ``lp.pos`` (a 0-d
        int64 tensor on the device): writes this step's self-attention K/V
        into ``lp.kc`` / ``lp.vc`` at ``pos`` in place, attends over every
        ``tgt_len`` position with those after ``pos`` masked, and returns
        the next tokens (B,).  It reads no host value, so it can be
        captured."""
        H, Dh = self._dims()
        scale = 1.0 / math.sqrt(Dh)
        at = lp.pos.reshape(1)
        invalid = lp.positions > lp.pos
        x = (params["tok"].index_select(0, tok)[:, None, :]
             + params["tgt_pos"][0].index_select(0, at)[None])
        for li, p in enumerate(params["dec"]):
            h = self._ln(x, p["ln1_w"], p["ln1_b"])
            q, k, v = (self._heads(h, p[f"s_{n}_w"], p[f"s_{n}_b"], H) for n in "qkv")
            lp.kc[li].index_copy_(2, at, k)
            lp.vc[li].index_copy_(2, at, v)
            x = x + (self._attend(q, lp.kc[li], lp.vc[li], scale, invalid) @ p["s_o_w"]
                     + p["s_o_b"])
            h = self._ln(x, p["ln2_w"], p["ln2_b"])
            q = self._heads(h, p["c_q_w"], p["c_q_b"], H)
            x = x + (self._attend(q, lp.ck[li], lp.cv[li], scale) @ p["c_o_w"] + p["c_o_b"])
            x = x + self._mlp(self._ln(x, p["ln3_w"], p["ln3_b"]), p)
        x = self._ln(x, params["lnf_w"], params["lnf_b"])
        logits = x[:, 0].float() @ params["head_w"].float() + params["head_b"].float()
        return logits.argmax(-1)

    # --------------------------------------------------------- the loop
    def _loop(self, params, ck, n_steps):
        """The tensors and the step of one graph key: the self-attention
        caches, the cross K/V, the (B, n_steps + 1) token buffer (column 0
        the BOS, step i reads column i and writes i + 1) and the position,
        a 0-d int64 tensor."""
        layers, B, H, Ls, Dh = ck.shape
        key = ("decode", B, Ls, n_steps, ck.dtype)
        lp = self._loops.get(key)
        if lp is None:
            dev = ck.device
            cache = (layers, B, H, self.model.tgt_len, Dh)
            lp = self._loops[key] = SimpleNamespace(
                kc=torch.zeros(cache, dtype=ck.dtype, device=dev),
                vc=torch.zeros(cache, dtype=ck.dtype, device=dev),
                ck=torch.empty_like(ck), cv=torch.empty_like(ck),
                tokens=torch.zeros((B, n_steps + 1), dtype=torch.long, device=dev),
                pos=torch.zeros((), dtype=torch.long, device=dev),
                positions=torch.arange(self.model.tgt_len, device=dev),
            )

            def step():
                tok = lp.tokens.index_select(1, lp.pos.reshape(1)).reshape(B)
                nxt = self._forward_one(params, lp, tok)
                lp.tokens.index_copy_(1, (lp.pos + 1).reshape(1), nxt.reshape(B, 1))
                lp.pos.add_(1)

            lp.step = step
        return key, lp

    def _decode(self, params, ck, cv, n_steps, bos_id):
        """``n_steps`` greedy steps from ``bos_id``: replayed from the key's
        CUDA graph on the card, eager on the CPU (or with ``_capture``
        off).  Returns the (B, n_steps) generated ids on the device."""
        key, lp = self._loop(params, ck, n_steps)
        lp.ck.copy_(ck)
        lp.cv.copy_(cv)
        lp.kc.zero_()
        lp.vc.zero_()
        lp.tokens.zero_()
        lp.tokens[:, 0] = bos_id
        lp.pos.zero_()
        if lp.kc.is_cuda and self._capture:
            self._graphs.run(key, lp.step, n_steps)
        else:
            for _ in range(n_steps):
                lp.step()
        return lp.tokens[:, 1:]

    # ------------------------------------------------------------ public
    def generate(self, src, new_tokens: int, bos_id: int = 0) -> np.ndarray:
        """(B, Ls) int source -> (B, new_tokens) greedy target ids."""
        if isinstance(src, torch.Tensor):
            src = src.cpu().numpy()
        src = np.asarray(src)
        if src.ndim != 2:
            raise ValueError("src must be (B, Ls)")
        if new_tokens < 1 or new_tokens > self.model.tgt_len:
            raise ValueError(f"new_tokens must be in [1, tgt_len={self.model.tgt_len}]")
        if src.shape[1] > self.model.src_len:
            raise ValueError(f"source length {src.shape[1]} > src_len {self.model.src_len}")
        device = self.model.tok_embed.weight.device
        with self._lock, torch.inference_mode():
            params = self._prepared()
            ck, cv = self._encode_cross(
                params, torch.as_tensor(src, dtype=torch.long).to(device))
            out = self._decode(params, ck, cv, int(new_tokens), int(bos_id))
            return out.cpu().numpy()  # the one readback
