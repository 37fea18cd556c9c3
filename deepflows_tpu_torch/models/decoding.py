"""KV-cache autoregressive decoding for TransformerLM (counterpart of
``KVCacheDecoder`` in ``deepflows_tpu/models/decoding.py``).

``generate`` prepares the weights once (cast, q/k/v fusion, optional int8
quantisation) into the decoder's own tensors, runs a PREFILL over the
prompt padded to ``max_len`` that fills a ``(layers, B, H, max_len, Dh)``
cache — the JAX layout — and then a DECODE of one token per step against
the cache, with one host readback at the end.  ``generate_beam`` decodes
the same step at B × num_beams rows.

Where JAX runs each decode as one ``fori_loop`` program, the port captures
one step in a CUDA graph on the card (``jit.StepGraphs``) and replays it
once a token.  Every value that changes from step to step (the position,
the step index, the tokens, the caches, the beams' scores) lives in a
tensor on the card that the step updates in place; the sampling draw comes
from a generator registered with the graph.  On CPU tensors the same step
function runs eagerly: that is the graph's plain twin.  Prefill runs
eagerly on both.  A decoder serves one generate at a time and keeps each
graph key's tensors between calls.

``quant="int8"`` and ``quant="w8a8"`` route every attention, MLP and head
matrix through the hand-written CUDA kernels of ``ops/quant.py``
(``int8_matmul``, ``w8a8_matmul``); on CPU tensors through their plain
twins.  The Llama/Mixtral decoders and the engine's and speculative
decoder's forwards (``_forward_multi``, ``_forward_chunk``, the paged
variants) come with later slices.
"""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace

import numpy as np
import torch

from ..jit import StepGraphs
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


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _copy_into(dst, src):
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
        return
    for k, v in (src.items() if isinstance(src, dict) else enumerate(src)):
        _copy_into(dst[k], v)


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
        self._params = None  # the prepared weights every step reads
        self._loops = {}  # graph key -> the tensors and the function of its step
        self._graphs = StepGraphs()
        self._generator = None
        self._lock = threading.Lock()
        self._capture = True  # False runs the eager loop on the card too

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

    def _prepared(self):
        """The module's current weights, prepared (once per generate(), so
        live weight updates are picked up, as in the JAX package) into the
        tensors every captured step reads.  The first call clones the
        prepared tree, since a cast may return the module's own tensor."""
        fresh = self._prep_tree(self._gather())
        if self._params is None:
            self._params = _clone(fresh)
        else:
            _copy_into(self._params, fresh)
        return self._params

    def _rng(self, device, seed):
        """The decoder's one generator, which every sampling graph reads,
        seeded for this generate()."""
        if self._generator is None:
            self._generator = torch.Generator(device=device)
        return self._generator.manual_seed(seed)

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
        truncation and a categorical draw from ``generator``.  ``top_k`` and
        ``do_sample`` are static; ``temperature`` and ``top_p`` may be 0-d
        f32 tensors, so one captured step serves every value."""
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
        """One decode step for a (N,) token batch at position ``pos``, a 0-d
        int64 tensor on the tokens' device (JAX's traced position): writes
        this step's K/V into the caches in place and returns (logits (N, V)
        f32, kc, vc).  It reads no value back to the host, so it can be
        captured."""
        lm = self.lm
        H = lm.blocks[0].attn.num_heads
        scale = 1.0 / math.sqrt(lm.blocks[0].attn.head_dim)
        N = tok.shape[0]
        at = pos.reshape(1)
        # index_select and index_copy_ at ``at``: lax.dynamic_slice and
        # dynamic_update_slice in the JAX step
        x = params["tok"].index_select(0, tok)[:, None, :] + params["pos"].index_select(1, at)
        invalid = positions > pos
        for li, p in enumerate(params["blocks"]):
            h = self._ln(x, p["ln1_w"], p["ln1_b"])
            q, k_new, v_new = self._attn_proj(h, p, H)  # (N, H, 1, Dh)
            kc[li].index_copy_(2, at, k_new)
            vc[li].index_copy_(2, at, v_new)
            s = self._scores(q, kc[li], scale).masked_fill(invalid, -1e30)
            attn = torch.softmax(s, -1).to(vc.dtype)
            o = (attn @ vc[li]).transpose(1, 2).reshape(N, 1, -1)
            x = x + (_mm(o, p["o_w"]) + p["o_b"])
            x = x + self._mlp(self._ln(x, p["ln2_w"], p["ln2_b"]), p)
        x = self._ln(x, params["lnf_w"], params["lnf_b"])
        return self._head(x[:, 0], params), kc, vc

    # --------------------------------------------------------- the loops
    def _loop(self, key, make):
        """The loop of ``key``, made by ``make()`` at its first use."""
        lp = self._loops.get(key)
        if lp is None:
            lp = self._loops[key] = make()
        return lp

    def _run(self, key, loop, times):
        """``times`` steps of ``loop``: replayed from its CUDA graph on the
        card, called eagerly on the CPU (or with ``_capture`` off)."""
        if loop.kc.is_cuda and self._capture:
            gens = (self._generator,) if loop.samples else ()
            self._graphs.run(key, loop.step, times, gens)
        else:
            for _ in range(times):
                loop.step()

    def _loop_tensors(self, shape, dtype, device, samples):
        """The tensors every loop keeps across generate() calls: the caches,
        the position of the token a step forwards and the step index (0-d
        int64), and the key positions."""
        return SimpleNamespace(
            kc=torch.zeros(shape, dtype=dtype, device=device),
            vc=torch.zeros(shape, dtype=dtype, device=device),
            pos=torch.zeros((), dtype=torch.long, device=device),
            i=torch.zeros((), dtype=torch.long, device=device),
            positions=torch.arange(shape[3], device=device),
            samples=samples,
        )

    def _decode_loop(self, params, shape, dtype, device, top_k, has_top_p, do_sample):
        """The tensors and the step of one decode key.  The token buffer is
        max_len wide: the last step's token lands at n_steps <= max_len - 1
        and is dropped, as in the JAX loop."""
        lp = self._loop_tensors(shape, dtype, device, do_sample)
        B, L = shape[1], shape[3]
        lp.tokens = torch.zeros((B, L), dtype=torch.long, device=device)
        lp.temperature = torch.ones((), dtype=torch.float32, device=device)
        lp.top_p = torch.ones((), dtype=torch.float32, device=device) if has_top_p else None

        def step():
            tok = lp.tokens.index_select(1, lp.i.reshape(1)).reshape(B)
            logits, _, _ = self._forward_one(params, lp.kc, lp.vc, tok, lp.pos, lp.positions)
            nxt = self._select(logits, self._generator, lp.temperature, top_k, lp.top_p,
                               do_sample)
            lp.tokens.index_copy_(1, (lp.i + 1).reshape(1), nxt.reshape(B, 1))
            lp.pos.add_(1)
            lp.i.add_(1)

        lp.step = step
        return lp

    # ------------------------------------------------------------ decode
    def _decode(
        self, params, caches, tok0, pos0, n_steps,
        temperature=None, top_k=None, top_p=None, do_sample=False,
    ):
        """Decode ``n_steps`` steps from ``tok0`` at position ``pos0``: step
        i forwards token i and selects token i + 1, so the last step's
        selection falls outside the (B, n_steps) buffer, as in the JAX loop
        (which compiles one program per power-of-two bucket of ``n_steps``;
        one captured step replayed ``n_steps`` times needs no buckets).  The
        draw reads the decoder's generator (``_rng``).  ``params`` must be
        the decoder's prepared tree (``_prepared``).  Returns (tokens
        (B, n_steps) incl. tok0, the loop's caches)."""
        kc, vc = caches
        key = ("decode", tuple(kc.shape), kc.dtype, do_sample, top_k, top_p is not None)
        lp = self._loop(key, lambda: self._decode_loop(
            params, kc.shape, kc.dtype, kc.device, top_k, top_p is not None, do_sample))
        lp.kc.copy_(kc)
        lp.vc.copy_(vc)
        lp.tokens.zero_()
        lp.tokens[:, 0] = tok0
        lp.pos.fill_(pos0)
        lp.i.zero_()
        if do_sample:
            lp.temperature.fill_(temperature)
            if top_p is not None:
                lp.top_p.fill_(top_p)
        self._run(key, lp, n_steps)
        return lp.tokens[:, :n_steps].clone(), (lp.kc, lp.vc)

    # ------------------------------------------------------- beam search
    def _beam_loop(self, params, shape, dtype, device, B, W, V, eos_id):
        """The tensors and the step of one beam key, at B·W cache rows."""
        lp = self._loop_tensors(shape, dtype, device, False)
        L = shape[3]
        lp.tokens = torch.zeros((B, W, L), dtype=torch.long, device=device)
        lp.scores = torch.zeros((B, W), dtype=torch.float32, device=device)
        lp.fin = torch.zeros((B, W), dtype=torch.bool, device=device)
        lp.lens = torch.ones((B, W), dtype=torch.float32, device=device)
        brow = torch.arange(B, device=device)[:, None]
        if eos_id is not None:  # a frozen beam's only continuation: eos at log-prob 0
            frozen = torch.full((W,), -math.inf, device=device)
            frozen[0] = 0.0

        def step():
            tok = lp.tokens.index_select(2, (lp.i - 1).reshape(1)).reshape(B * W)
            logits, _, _ = self._forward_one(params, lp.kc, lp.vc, tok, lp.pos, lp.positions)
            logits = logits.reshape(B, W, V)
            # each beam's W best continuations by logit, then the W best of
            # those W·W by score: the beams of one top-W over all W·V
            # scores, and with one beam greedy's argmax, which a sum rounded
            # at the score's magnitude would not always keep
            cand = torch.topk(logits, W).indices  # (B, W, W)
            logp = torch.log_softmax(logits, -1).gather(2, cand)
            if eos_id is not None:
                cand = torch.where(lp.fin[:, :, None], eos_id, cand)
                logp = torch.where(lp.fin[:, :, None], frozen, logp)
            total = lp.scores[:, :, None] + logp
            scores, idx = torch.topk(total.reshape(B, W * W), W)
            parent = idx // W  # (B, W)
            tok_new = cand.reshape(B, W * W).gather(1, idx)
            # the caches' reorder by beam parent: one gather of B·W rows
            gidx = (brow * W + parent).reshape(-1)
            lp.kc.copy_(lp.kc.index_select(1, gidx))
            lp.vc.copy_(lp.vc.index_select(1, gidx))
            lp.tokens.copy_(lp.tokens.gather(1, parent[:, :, None].expand(B, W, L)))
            lp.tokens.index_copy_(2, lp.i.reshape(1), tok_new[:, :, None])
            fin = lp.fin.gather(1, parent)
            lp.lens.copy_(lp.lens.gather(1, parent) + (~fin).float())
            if eos_id is not None:
                fin = fin | (tok_new == eos_id)
            lp.fin.copy_(fin)
            lp.scores.copy_(scores)
            lp.pos.add_(1)
            lp.i.add_(1)

        lp.step = step
        return lp

    def _beam(self, params, caches, logits0, plen, n_steps, num_beams, eos_id, length_penalty):
        """Beam-search ``n_steps`` tokens (the JAX package's one-program
        ``_beam``).  Each batch row of the (B,) prefill's caches is
        replicated ``num_beams`` times, so a step forwards B·W tokens and
        reorders the caches by beam parent with one gather.  Finished beams
        (``eos_id`` emitted) are frozen: their only continuation is
        ``eos_id`` at log-prob 0, so their score carries unchanged.  A step
        keeps the W best of the W·V scores as JAX's ``lax.top_k`` does,
        found among each beam's W best continuations by logit.  The
        step is captured once per (rows, W, eos_id) and replayed
        ``n_steps - 1`` times.  Step i forwards token i - 1 at position
        plen + i - 1, where ``_decode`` puts it; the JAX loop starts its
        position one further, at plen + 1
        (``deepflows_tpu/models/decoding.py:788``).  Returns (tokens (B,
        W, n_steps), scores (B, W)) sorted best-first by the
        length-penalised score sum(logp) / len ** length_penalty."""
        W = num_beams
        kc0, vc0 = caches
        layers, B = kc0.shape[:2]
        V = logits0.shape[-1]
        rows = (layers, B * W, *kc0.shape[2:])
        key = ("beam", rows, kc0.dtype, B, W, eos_id)
        lp = self._loop(key, lambda: self._beam_loop(
            params, rows, kc0.dtype, kc0.device, B, W, V, eos_id))
        scores0, tok0 = torch.topk(torch.log_softmax(logits0, -1), W)  # (B, W)
        lp.tokens.zero_()
        lp.tokens[:, :, 0] = tok0
        lp.scores.copy_(scores0)
        if eos_id is None:
            lp.fin.zero_()
        else:
            lp.fin.copy_(tok0 == eos_id)
        lp.lens.fill_(1.0)
        # row b * W + w holds batch row b, as jnp.repeat(kc, W, axis=1)
        lp.kc.view(layers, B, W, *kc0.shape[2:]).copy_(kc0[:, :, None])
        lp.vc.view(layers, B, W, *vc0.shape[2:]).copy_(vc0[:, :, None])
        lp.pos.fill_(plen)
        lp.i.fill_(1)
        self._run(key, lp, n_steps - 1)
        adj = lp.scores / lp.lens ** length_penalty
        order = torch.argsort(-adj, dim=-1, stable=True)  # best-first
        tokens = lp.tokens.gather(1, order[:, :, None].expand(lp.tokens.shape))
        return tokens[:, :, :n_steps], adj.gather(1, order)

    def generate_beam(
        self,
        idx,
        new_tokens: int,
        num_beams: int = 4,
        eos_id=None,
        length_penalty: float = 1.0,
        return_all: bool = False,
    ):
        """Beam-search decode: returns the highest-scoring continuation of
        the (B, L) prompt as (B, L + new_tokens) (``num_beams == 1`` is
        greedy ``generate``).  With ``return_all=True`` returns (sequences
        (B, num_beams, L + new_tokens) best-first, scores (B, num_beams)),
        a score being the sequence's log-prob over generated-length **
        length_penalty.  ``eos_id`` freezes a beam once emitted (its tail
        pads with ``eos_id``).  One prefill, the replayed step and one
        readback."""
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        idx = np.asarray(idx)
        B, plen = idx.shape
        if plen < 1:
            raise ValueError("prompt must have at least one token")
        if num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        L = self.lm.max_len
        if plen + new_tokens > L:
            raise ValueError(
                f"prompt_len {plen} + new_tokens {new_tokens} exceeds "
                f"max_len {L}"
            )
        if new_tokens == 0:
            raise ValueError("beam search needs new_tokens >= 1")
        device = self.lm.tok_embed.weight.device
        with self._lock, torch.inference_mode():
            params = self._prepared()
            prompt = torch.zeros((B, L), dtype=torch.long)
            prompt[:, :plen] = torch.as_tensor(idx, dtype=torch.long)
            kc, vc, logits0 = self._prefill(params, prompt.to(device), plen)
            tokens, scores = self._beam(
                params, (kc, vc), logits0, plen, new_tokens, num_beams, eos_id,
                length_penalty,
            )
            tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()  # the one readback
        seqs = np.concatenate(
            [np.broadcast_to(idx[:, None], (B, num_beams, plen)),
             tokens.astype(idx.dtype)],
            axis=2,
        )
        if return_all:
            return seqs, scores
        return seqs[:, 0]

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
        truncation; ``seed`` seeds the draw's ``torch.Generator``, which
        the decoder keeps for its sampling graphs."""
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
        with self._lock, torch.inference_mode():
            params = self._prepared()
            prompt = torch.zeros((B, L), dtype=torch.long)
            prompt[:, :plen] = torch.as_tensor(idx, dtype=torch.long)
            kc, vc, logits0 = self._prefill(params, prompt.to(device), plen)
            if new_tokens == 0:
                return idx
            gen = self._rng(device, seed)
            tok0 = self._select(logits0, gen, temperature, top_k, top_p, do_sample)
            tokens, _ = self._decode(
                params, (kc, vc), tok0, plen, new_tokens,
                temperature, top_k, top_p, do_sample,
            )
            out = tokens.cpu().numpy()  # the one readback
        return np.concatenate([idx, out.astype(idx.dtype)], 1)
