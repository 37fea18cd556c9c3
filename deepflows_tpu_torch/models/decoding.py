"""KV-cache autoregressive decoding for TransformerLM (counterpart of
``KVCacheDecoder`` in ``deepflows_tpu/models/decoding.py``).

``generate`` prepares the weights once (cast, q/k/v fusion, optional int8
quantisation), runs a PREFILL over the prompt padded to ``max_len`` that
fills a ``(layers, B, H, max_len, Dh)`` cache — the JAX layout — and then a
DECODE of one token per step against the cache, with one host readback at
the end.  Where JAX runs the decode as one ``fori_loop`` program, the port
runs a plain Python loop of the same steps; the kernels queue on the stream
and the host never waits inside the loop.  Where JAX returns updated caches
functionally, the port writes them in place by slice assignment.

``quant="int8"`` and ``quant="w8a8"`` route every attention, MLP and head
matrix through the hand-written CUDA kernels of ``ops/quant.py``
(``int8_matmul``, ``w8a8_matmul``); on CPU tensors through their plain
twins.  The Llama/Mixtral decoders, beam search, and the engine's and
speculative decoder's forwards (``_forward_multi``, ``_forward_chunk``, the
paged variants) come with later slices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quant import (
    int8_matmul,
    quantize_int8,
    quantize_int8_rows,
    w8a8_matmul,
)

# weight matrices quantised under quant="int8"/"w8a8" (biases, layernorms
# and the embeddings stay in the compute dtype; the head is quantised at top
# level; q/k/v fuse into qkv_w before quantisation — per-channel scales make
# fused and separate quantisation identical)
_QUANT_KEYS = frozenset(("qkv_w", "o_w", "fc1_w", "fc2_w"))
_QKV_KEYS = frozenset(("q_w", "k_w", "v_w", "q_b", "k_b", "v_b"))


def _mm(x, w):
    """``x @ w`` where ``w`` is a dense tensor or a quantised dict.  The
    mode is in the key holding the int8 weight, as in the JAX package:
    ``{"q", "s"}`` is weight-only int8 (``int8_matmul``), ``{"w8a8", "s"}``
    also quantises the activations per row (``w8a8_matmul``)."""
    if isinstance(w, dict):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if "w8a8" in w:
            xq, sx = quantize_int8_rows(x2)
            y = w8a8_matmul(xq, sx, w["w8a8"], w["s"], out_dtype=x.dtype)
        else:
            y = int8_matmul(x2, w["q"], w["s"])
        return y.reshape(*lead, y.shape[-1])
    return x @ w


class KVCacheDecoder:
    def __init__(self, lm, compute_dtype=None, quant=None):
        """``compute_dtype=torch.bfloat16`` casts the weights once per
        generate() and runs prefill and decode in bf16; layernorm
        statistics, the softmax and the logits stay f32.

        ``quant="int8"`` stores every attention/MLP/head weight matrix as
        int8 with a per-output-channel f32 scale and widens it inside the
        ``int8_matmul`` kernel.  ``quant="w8a8"`` also quantises the
        activations per row each step and runs ``w8a8_matmul``."""
        if quant not in (None, "int8", "w8a8"):
            raise ValueError(
                f"quant must be None, 'int8' or 'w8a8', got {quant!r}"
            )
        self.lm = lm
        self.compute_dtype = compute_dtype
        self.quant = quant

    # ------------------------------------------------------------ params
    def _cast(self, a):
        if self.compute_dtype is not None and a.is_floating_point():
            return a.to(self.compute_dtype)
        return a

    def _wprep(self, w):
        if self.quant is None:
            return self._cast(w)
        q, s = quantize_int8(w)
        return {"w8a8" if self.quant == "w8a8" else "q": q, "s": s}

    def _prep_tree(self, tree):
        """Cast, fuse q/k/v into one (D, 3E) matrix, and quantise; once per
        generate()."""
        out = {}
        for k, v in tree.items():
            if k == "blocks":
                nbs = []
                for blk in v:
                    nb = {
                        bk: (self._wprep(bv) if bk in _QUANT_KEYS else self._cast(bv))
                        for bk, bv in blk.items()
                        if bk not in _QKV_KEYS
                    }
                    nb["qkv_w"] = self._wprep(
                        torch.cat([blk["q_w"], blk["k_w"], blk["v_w"]], 1)
                    )
                    nb["qkv_b"] = self._cast(
                        torch.cat([blk["q_b"], blk["k_b"], blk["v_b"]], -1)
                    )
                    nbs.append(nb)
                out[k] = nbs
            elif k == "head_w":
                out[k] = self._wprep(v)
            else:
                out[k] = self._cast(v)
        return out

    def _gather(self):
        """The module's parameter tensors, detached, in the JAX tree's
        layout."""
        lm = self.lm
        blocks = []
        for blk in lm.blocks:
            a = blk.attn
            named = dict(
                ln1_w=blk.norm1.weight, ln1_b=blk.norm1.bias,
                q_w=a.q_proj.weight, q_b=a.q_proj.bias,
                k_w=a.k_proj.weight, k_b=a.k_proj.bias,
                v_w=a.v_proj.weight, v_b=a.v_proj.bias,
                o_w=a.out_proj.weight, o_b=a.out_proj.bias,
                ln2_w=blk.norm2.weight, ln2_b=blk.norm2.bias,
                fc1_w=blk.mlp[0].weight, fc1_b=blk.mlp[0].bias,
                fc2_w=blk.mlp[2].weight, fc2_b=blk.mlp[2].bias,
            )
            blocks.append({k: t.detach() for k, t in named.items()})
        return dict(
            tok=lm.tok_embed.weight.detach(),
            pos=lm.pos_embed.detach(),
            blocks=blocks,
            lnf_w=lm.norm.weight.detach(),
            lnf_b=lm.norm.bias.detach(),
            head_w=lm.head.weight.detach(),
            head_b=lm.head.bias.detach(),
        )

    # ------------------------------------------------------- pure pieces
    @staticmethod
    def _ln(x, w, b, eps=1e-5):
        xf = x.float()  # stats in f32 even for bf16 compute
        xc = xf - xf.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        return (xc / torch.sqrt(var + eps)).to(x.dtype) * w + b

    @staticmethod
    def _head(x, params):
        """Final-vocab logits with f32 accumulation and f32 storage."""
        x = x.contiguous()
        hw = params["head_w"]
        hb = params["head_b"].float()
        if isinstance(hw, dict):
            if "w8a8" in hw:
                xq, sx = quantize_int8_rows(x)
                return w8a8_matmul(
                    xq, sx, hw["w8a8"], hw["s"], out_dtype=torch.float32
                ) + hb
            return int8_matmul(x, hw["q"], hw["s"], out_dtype=torch.float32) + hb
        return x.float() @ hw.float() + hb

    def _attn_proj(self, h, p, H):
        """h: (B, T, E) -> q, k, v each (B, H, T, Dh), via the fused (E, 3E)
        projection."""
        B, T, E = h.shape
        y = _mm(h, p["qkv_w"]) + p["qkv_b"]
        q, k, v = y.split(E, dim=-1)

        def sh(z):
            return z.reshape(B, T, H, E // H).transpose(1, 2)

        return sh(q), sh(k), sh(v)

    @staticmethod
    def _select(logits, generator, temperature, top_k, top_p, do_sample):
        """Next-token selection from (B, V) f32 logits: greedy argmax (the
        first maximum), or temperature scaling, optional top-k and top-p
        truncation and a categorical draw from ``generator``."""
        if not do_sample:
            return logits.argmax(-1)
        logits = logits / temperature
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, -1e30)
        if top_p is not None:
            srt = torch.sort(logits, -1, descending=True).values
            probs = torch.softmax(srt, -1)
            # drop tokens whose EXCLUSIVE cumulative prob already >= top_p
            # (the nucleus always keeps at least the argmax)
            beyond = probs.cumsum(-1) - probs >= top_p
            thresh = srt.masked_fill(beyond, math.inf).amin(-1, keepdim=True)
            logits = logits.masked_fill(logits < thresh, -1e30)
        # Gumbel-max, the construction of jax.random.categorical
        u = torch.rand(
            logits.shape, generator=generator, device=logits.device,
            dtype=torch.float32,
        ).clamp_min(torch.finfo(torch.float32).tiny)
        return (logits - torch.log(-torch.log(u))).argmax(-1)

    @staticmethod
    def _mlp(h, p):
        h = _mm(h, p["fc1_w"]) + p["fc1_b"]
        h = torch.nn.functional.gelu(h)  # exact erf, like nn.GELU
        return _mm(h, p["fc2_w"]) + p["fc2_b"]

    @staticmethod
    def _scores(q, k, scale):
        # the product in the compute dtype, then promoted to f32 and scaled
        # (the JAX reference multiplies by a numpy float64 scale, which
        # promotes bf16 scores to f32 before the scaling)
        return (q @ k.transpose(-1, -2)).float() * scale

    # ----------------------------------------------------------- prefill
    def _prefill(self, params, prompt, plen):
        """prompt: (B, max_len) int64, first ``plen`` real.  Returns
        (k_cache, v_cache each (layers, B, H, max_len, Dh), logits (B, V))."""
        lm = self.lm
        H = lm.blocks[0].attn.num_heads
        L = lm.max_len
        scale = 1.0 / math.sqrt(lm.blocks[0].attn.head_dim)
        x = params["tok"][prompt] + params["pos"][:, :L]
        causal = torch.triu(
            torch.full((L, L), -1e30, dtype=torch.float32, device=x.device), 1
        )
        B, E = x.shape[0], x.shape[-1]
        # the cache is allocated once and filled in place, layer by layer
        kc = torch.empty(
            (len(params["blocks"]), B, H, L, E // H), dtype=x.dtype, device=x.device
        )
        vc = torch.empty_like(kc)
        for li, p in enumerate(params["blocks"]):
            h = self._ln(x, p["ln1_w"], p["ln1_b"])
            q, k, v = self._attn_proj(h, p, H)
            kc[li] = k
            vc[li] = v
            s = self._scores(q, k, scale) + causal
            attn = torch.softmax(s, -1).to(v.dtype)
            o = (attn @ v).transpose(1, 2).reshape(B, L, E)
            x = x + (_mm(o, p["o_w"]) + p["o_b"])
            x = x + self._mlp(self._ln(x, p["ln2_w"], p["ln2_b"]), p)
        x = self._ln(x, params["lnf_w"], params["lnf_b"])
        return kc, vc, self._head(x[:, plen - 1], params)

    # ------------------------------------------------- one-token forward
    def _forward_one(self, params, kc, vc, tok, pos, positions):
        """One decode step for a (N,) token batch at position ``pos``: writes
        this step's K/V into the caches in place and returns
        (logits (N, V) f32, kc, vc)."""
        lm = self.lm
        H = lm.blocks[0].attn.num_heads
        scale = 1.0 / math.sqrt(lm.blocks[0].attn.head_dim)
        N = tok.shape[0]
        x = params["tok"][tok][:, None, :] + params["pos"][:, pos:pos + 1]
        invalid = positions > pos
        for li, p in enumerate(params["blocks"]):
            h = self._ln(x, p["ln1_w"], p["ln1_b"])
            q, k_new, v_new = self._attn_proj(h, p, H)  # (N, H, 1, Dh)
            kc[li, :, :, pos] = k_new[:, :, 0]
            vc[li, :, :, pos] = v_new[:, :, 0]
            s = self._scores(q, kc[li], scale).masked_fill(invalid, -1e30)
            attn = torch.softmax(s, -1).to(vc.dtype)
            o = (attn @ vc[li]).transpose(1, 2).reshape(N, 1, -1)
            x = x + (_mm(o, p["o_w"]) + p["o_b"])
            x = x + self._mlp(self._ln(x, p["ln2_w"], p["ln2_b"]), p)
        x = self._ln(x, params["lnf_w"], params["lnf_b"])
        return self._head(x[:, 0], params), kc, vc

    # ------------------------------------------------------------ decode
    def _decode(
        self, params, caches, tok0, pos0, n_steps,
        generator=None, temperature=None, top_k=None, top_p=None,
        do_sample=False,
    ):
        """Decode ``n_steps`` steps from ``tok0`` at position ``pos0``: step
        i forwards token i and selects token i + 1, so the last step's
        selection falls outside the (B, n_steps) buffer, as in the JAX loop
        (which compiles one program per power-of-two bucket of ``n_steps``;
        the port needs no buckets).  Returns (tokens (B, n_steps) incl.
        tok0, caches)."""
        kc, vc = caches
        B = kc.shape[1]
        tokens = torch.zeros((B, n_steps), dtype=torch.long, device=kc.device)
        tokens[:, 0] = tok0
        positions = torch.arange(self.lm.max_len, device=kc.device)
        for i in range(n_steps):
            logits, kc, vc = self._forward_one(
                params, kc, vc, tokens[:, i], pos0 + i, positions
            )
            nxt = self._select(logits, generator, temperature, top_k, top_p, do_sample)
            if i + 1 < n_steps:
                tokens[:, i + 1] = nxt
        return tokens, (kc, vc)

    # ---------------------------------------------------------- generate
    def generate(
        self,
        idx,
        new_tokens: int,
        temperature: float = 0.0,
        top_k=None,
        top_p=None,
        seed: int = 0,
    ):
        """Decode ``new_tokens`` continuations of the (B, L) int prompt and
        return the (B, L + new_tokens) numpy array, like
        ``TransformerLM.generate``, with one host readback.

        ``temperature == 0`` is greedy argmax.  ``temperature > 0`` samples
        after temperature scaling, with optional ``top_k`` and ``top_p``
        truncation; ``seed`` seeds the draw's ``torch.Generator``."""
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        idx = np.asarray(idx)
        B, plen = idx.shape
        if plen < 1:
            raise ValueError("prompt must have at least one token")
        L = self.lm.max_len
        if plen + new_tokens > L:
            raise ValueError(
                f"prompt_len {plen} + new_tokens {new_tokens} exceeds "
                f"max_len {L}"
            )
        do_sample = temperature is not None and temperature > 0.0
        if not do_sample:
            temperature = top_k = top_p = None
        device = self.lm.tok_embed.weight.device
        with torch.inference_mode():
            params = self._prep_tree(self._gather())
            prompt = torch.zeros((B, L), dtype=torch.long)
            prompt[:, :plen] = torch.as_tensor(idx, dtype=torch.long)
            kc, vc, logits0 = self._prefill(params, prompt.to(device), plen)
            if new_tokens == 0:
                return idx
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            tok0 = self._select(logits0, gen, temperature, top_k, top_p, do_sample)
            tokens, _ = self._decode(
                params, (kc, vc), tok0, plen, new_tokens,
                gen, temperature, top_k, top_p, do_sample,
            )
            out = tokens.cpu().numpy()  # the one readback
        return np.concatenate([idx, out.astype(idx.dtype)], 1)
