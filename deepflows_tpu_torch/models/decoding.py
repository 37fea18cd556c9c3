"""KV-cache autoregressive decoding (counterpart of ``KVCacheDecoder``,
``LlamaKVCacheDecoder`` and ``MixtralKVCacheDecoder`` in
``deepflows_tpu/models/decoding.py``).  ``KVCacheDecoder(lm)`` returns the
decoder of the model's family: TransformerLM's (this class), LlamaLM's or
MixtralLM's.

``generate`` prepares the weights once (cast, fusion of q/k/v and of the
Llama MLP's gate/up, optional int8 quantisation) into the decoder's own
tensors, runs a PREFILL over the prompt padded to ``max_len`` that fills a
``(layers, B, heads, max_len, Dh)`` cache — the JAX layout, ``num_kv_heads``
wide for the Llama family — and then a DECODE of one token per step
against the cache, with one host readback at the end.  ``generate_beam``
decodes the same step at B × num_beams rows.  A sliding-window Llama
streams past ``max_len`` on a ring cache (``LlamaKVCacheDecoder``).

Where JAX runs each decode as one ``fori_loop`` program, the port captures
one step in a CUDA graph on the card (``jit.StepGraphs``) and replays it
once a token.  Every value that changes from step to step (the position,
the step index, the tokens, the caches, the beams' scores) lives in a
tensor on the card that the step updates in place; the sampling draw comes
from a generator registered with the graph.  On CPU tensors the same step
function runs eagerly: that is the graph's plain twin.  Prefill runs
eagerly on both.  A decoder serves one generate at a time and keeps each
graph key's tensors between calls.

``quant="int8"`` and ``quant="w8a8"`` route the attention, MLP and head
matrices (Mixtral: attention and head; its experts stay in the compute
dtype) through the hand-written CUDA kernels of ``ops/quant.py``
(``int8_matmul``, ``w8a8_matmul``); on CPU tensors through their plain
twins.

Every decode forward runs one shared block loop a family
(``_forward_rows``): ``_forward_one`` (one position for the whole batch),
``_forward_multi`` (each row at its own position: the in-flight engine's
step, ``models/engine.py``), ``_forward_multi_paged`` (the same over a
pool of cache blocks addressed through a block table) and
``_forward_chunk`` (g tokens a row from each row's position: the
speculative verify forward, ``models/speculative.py``, and the engine's
prefix-hit suffix).  Each takes its positions as device tensors and
writes the cache in place with ``index_copy_`` or ``index_put_``, so each
can be captured.
"""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace

import numpy as np
import torch

from ..jit import StepGraphs
from ..nn.lora import assert_no_unmerged_lora
from ..nn.modules.attention import rope_tables
from ..ops.quant import (
    int8_matmul,
    quantize_int8,
    quantize_int8_rows,
    w8a8_matmul,
)


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


def _invalid_keys(pos_keys, pos_q, window):
    """The decode forwards' mask: keys after the query or, with a sliding
    window, ``window`` or more behind it.  The operands broadcast."""
    m = pos_keys > pos_q
    if window:
        m = m | (pos_keys <= pos_q - window)
    return m


def _arange(n, like):
    return torch.arange(n, device=like.device)


def _scatter_step(cache, layer, new, posv):
    """One step's K/V at per-slot positions, in place: cache (layers, S, Hc,
    L, Dh), new (S, Hc, 1, Dh), posv (S,) -> ``cache[layer, s, h, posv[s]] =
    new[s, h, 0]``."""
    S, Hc = new.shape[:2]
    cache[layer].index_put_(
        (_arange(S, new)[:, None], _arange(Hc, new)[None, :], posv[:, None]),
        new[:, :, 0].to(cache.dtype),
    )


def _scatter_chunk(cache, layer, new, posv):
    """A g-token chunk's K/V at each row's window of positions, in place:
    new (B, Hc, g, Dh) -> ``cache[layer, b, h, posv[b] + j] = new[b, h, j]``.
    The windows must lie inside the cache (XLA would clamp or drop what
    does not; the callers keep every window below max_len)."""
    B, Hc, g = new.shape[:3]
    at = posv[:, None] + _arange(g, new)  # (B, g)
    cache[layer].index_put_(
        (_arange(B, new)[:, None, None], _arange(Hc, new)[None, :, None], at[:, None, :]),
        new.to(cache.dtype),
    )


def _paged_scatter_step(pool, layer, new, tbl, posv, block_size):
    """One step's K/V into the paged pool, in place: pool (layers, blocks,
    Hc, bs, Dh), tbl (S, nb) block table, posv (S,) logical positions ->
    ``pool[layer, tbl[s, posv[s] // bs], h, posv[s] % bs] = new[s, h, 0]``.
    Blocks belong to one slot each; slots whose table points at the null
    block 0 write there, and block 0 is never read unmasked."""
    Hc = new.shape[1]
    blk = tbl.gather(1, torch.div(posv, block_size, rounding_mode="floor")[:, None])
    pool[layer].index_put_(
        (blk, _arange(Hc, new)[None, :], (posv % block_size)[:, None]),
        new[:, :, 0].to(pool.dtype),
    )


def _paged_gather(pool, layer, tbl):
    """A layer's per-slot K or V from the paged pool: (S, Hc, nb·bs, Dh),
    logical position j of slot s read from ``pool[layer, tbl[s, j // bs],
    :, j % bs]``."""
    g = pool[layer][tbl]  # (S, nb, Hc, bs, Dh)
    S, nb, Hc, bs, Dh = g.shape
    return g.transpose(1, 2).reshape(S, Hc, nb * bs, Dh)


def _categorical(logits, generator):
    """One categorical draw a row from (N, V) logits, by Gumbel-max (the
    construction of ``jax.random.categorical``) on ``generator``'s
    uniforms."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32,
    ).clamp_min(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(-1)


class KVCacheDecoder:
    # how a block's gathered tensors are prepared: the groups concatenated
    # along their last axis into one matrix (or bias), the matrices then
    # quantised under quant="int8"/"w8a8" (per-channel scales make fused
    # and separate quantisation identical), and the entries kept as they
    # are; every other entry is cast to the compute dtype.  The head is
    # quantised at top level.
    _FUSED = {"qkv_w": ("q_w", "k_w", "v_w"), "qkv_b": ("q_b", "k_b", "v_b")}
    _QUANT_KEYS = frozenset(("qkv_w", "o_w", "fc1_w", "fc2_w"))
    _KEEP_KEYS = frozenset()
    _stream_ok = False  # streaming past max_len needs rope: learned positions stop there

    def __new__(cls, lm, *args, **kwargs):
        # KVCacheDecoder(model) returns the decoder of the model's family
        if cls is KVCacheDecoder:
            from .llama import LlamaLM
            from .mixtral import MixtralLM

            if isinstance(lm, MixtralLM):
                return super().__new__(MixtralKVCacheDecoder)
            if isinstance(lm, LlamaLM):
                return super().__new__(LlamaKVCacheDecoder)
        return super().__new__(cls)

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
        # the steps read the projection weights directly: an unmerged LoRA
        # adapter would be dropped
        assert_no_unmerged_lora(lm, type(self).__name__)
        self.lm = lm
        self.compute_dtype = compute_dtype
        self.quant = quant
        self._params = None  # the prepared weights every step reads
        self._loops = {}  # graph key -> the tensors and the function of its step
        self._graphs = StepGraphs()
        self._generator = None
        self._lock = threading.Lock()
        self._capture = True  # False runs the eager loop on the card too
        # a sliding-window model masks every decode forward to its band
        self.window = getattr(lm.blocks[0].attn, "window", None)
        self._rope_len = 0  # rope table length while a generate streams

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

    def _prep_block(self, blk):
        blk = dict(blk)
        for name, parts in self._FUSED.items():
            blk[name] = torch.cat([blk.pop(k) for k in parts], -1)
        return {
            k: v if k in self._KEEP_KEYS
            else self._wprep(v) if k in self._QUANT_KEYS else self._cast(v)
            for k, v in blk.items()
        }

    def _prep_tree(self, tree):
        """Cast, fuse (q/k/v into one (D, 3E) matrix, the Llama MLP's gate
        and up into one (D, 2·hidden)) and quantise; once per generate()."""
        return {
            k: [self._prep_block(b) for b in v] if k == "blocks"
            else self._wprep(v) if k == "head_w" else self._cast(v)
            for k, v in tree.items()
        }

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
        if isinstance(hw, dict):
            if "w8a8" in hw:
                xq, sx = quantize_int8_rows(x)
                y = w8a8_matmul(xq, sx, hw["w8a8"], hw["s"], out_dtype=torch.float32)
            else:
                y = int8_matmul(x, hw["q"], hw["s"], out_dtype=torch.float32)
        else:
            y = x.float() @ hw.float()
        return y + params["head_b"].float() if "head_b" in params else y

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
        return _categorical(logits, generator)

    @staticmethod
    def _select_multi(logits, generator, temp, top_p, smask, top_k, any_sample):
        """Per-slot selection for the in-flight engine from (S, V) logits:
        ``temp`` and ``top_p`` (S,) f32 per slot (0: off), ``smask`` (S,)
        bool picks sampling or greedy per slot; ``top_k`` is engine-wide
        and ``any_sample`` static, so an all-greedy step draws nothing and
        sorts no vocabulary."""
        greedy = logits.argmax(-1)
        if not any_sample:
            return greedy
        t = torch.where(smask, temp.clamp_min(1e-6), 1.0)[:, None]
        sl = logits / t
        if top_k is not None:
            kth = torch.topk(sl, top_k, dim=-1).values[..., -1:]
            sl = sl.masked_fill(sl < kth, -1e30)
        p = torch.where(top_p > 0, top_p, 1.0)[:, None]
        srt = torch.sort(sl, -1, descending=True).values
        probs = torch.softmax(srt, -1)
        beyond = probs.cumsum(-1) - probs >= p
        thresh = srt.masked_fill(beyond, math.inf).amin(-1, keepdim=True)
        sl = sl.masked_fill(sl < thresh, -1e30)
        return torch.where(smask, _categorical(sl, generator), greedy)

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

    # --------------------------------------------------- decode forwards
    def _mask(self, positions, rows):
        """Keys (``positions``, the cache's) each query at ``rows`` (N, T)
        may not see, shaped for ``_forward_rows``'s (N, H, T, L) scores."""
        return _invalid_keys(positions, rows[:, None, :, None], self.window)

    def _forward_rows(self, params, tok, rows, write, read, invalid):
        """The block loop of every decode forward: tokens ``tok`` (N, T) at
        positions ``rows`` ((N, T), or (1, 1) for all), a device tensor.
        ``write(li, k, v)`` stores layer li's new K/V (N, H, T, Dh) in the
        cache, ``read(li)`` returns the (K, V) attention reads, and keys
        where ``invalid`` are masked.  Returns logits (N, T, V) f32.  It
        reads no host value, so it can be captured."""
        lm = self.lm
        H = lm.blocks[0].attn.num_heads
        scale = 1.0 / math.sqrt(lm.blocks[0].attn.head_dim)
        N, T = tok.shape
        E = params["tok"].shape[1]
        x = (params["tok"].index_select(0, tok.reshape(-1)).view(N, T, E)
             + params["pos"][0].index_select(0, rows.reshape(-1)).view(*rows.shape, E))
        for li, p in enumerate(params["blocks"]):
            h = self._ln(x, p["ln1_w"], p["ln1_b"])
            q, k_new, v_new = self._attn_proj(h, p, H)  # (N, H, T, Dh)
            write(li, k_new, v_new)
            k, v = read(li)
            s = self._scores(q, k, scale).masked_fill(invalid, -1e30)
            attn = torch.softmax(s, -1).to(v.dtype)
            o = (attn @ v).transpose(1, 2).reshape(N, T, -1)
            x = x + (_mm(o, p["o_w"]) + p["o_b"])
            x = x + self._mlp(self._ln(x, p["ln2_w"], p["ln2_b"]), p)
        x = self._ln(x, params["lnf_w"], params["lnf_b"])
        return self._head(x.reshape(N * T, -1), params).view(N, T, -1)

    def _forward_one(self, params, kc, vc, tok, pos, positions):
        """One decode step for a (N,) token batch at position ``pos``, a 0-d
        int64 tensor on the tokens' device (JAX's traced position): writes
        this step's K/V into the caches in place (``index_copy_`` at
        ``pos``: JAX's ``dynamic_update_slice``) and returns (logits (N, V)
        f32, kc, vc)."""
        at = pos.reshape(1)

        def write(li, k, v):
            kc[li].index_copy_(2, at, k)
            vc[li].index_copy_(2, at, v)

        rows = at.view(1, 1)
        logits = self._forward_rows(params, tok[:, None], rows, write,
                                    lambda li: (kc[li], vc[li]), self._mask(positions, rows))
        return logits[:, 0], kc, vc

    def _forward_multi(self, params, kc, vc, tok, posv, positions):
        """One decode step where each row sits at its own position: tok (S,)
        tokens at posv (S,) int64 positions on the device.  The in-flight
        engine's step: the K/V land at each slot's position
        (``_scatter_step``) and each row is masked at its own position.
        Returns (logits (S, V) f32, kc, vc)."""
        rows = posv[:, None]

        def write(li, k, v):
            _scatter_step(kc, li, k, posv)
            _scatter_step(vc, li, v, posv)

        logits = self._forward_rows(params, tok[:, None], rows, write,
                                    lambda li: (kc[li], vc[li]), self._mask(positions, rows))
        return logits[:, 0], kc, vc

    def _forward_multi_paged(self, params, kp, vp, tbl, tok, posv, positions):
        """``_forward_multi`` over a paged cache: K/V live in a pool (layers,
        blocks, Hc, bs, Dh) addressed through the block table ``tbl`` (S,
        nb) int64; the write goes through the table
        (``_paged_scatter_step``) and attention reads each layer's gathered
        (S, Hc, nb·bs, Dh) view (``_paged_gather``).  ``positions`` is
        arange(nb·bs)."""
        bs = kp.shape[3]
        rows = posv[:, None]

        def write(li, k, v):
            _paged_scatter_step(kp, li, k, tbl, posv, bs)
            _paged_scatter_step(vp, li, v, tbl, posv, bs)

        logits = self._forward_rows(
            params, tok[:, None], rows, write,
            lambda li: (_paged_gather(kp, li, tbl), _paged_gather(vp, li, tbl)),
            self._mask(positions, rows))
        return logits[:, 0], kp, vp

    def _forward_chunk(self, params, kc, vc, toks, posv, positions):
        """A g-token chunk a row against the cache: toks (B, g), row b's
        token j at position ``posv[b] + j``.  Each layer writes all g K/V
        (``_scatter_chunk``) before attending, causal within the chunk and
        against the cache.  Returns (logits (B, g, V) f32, kc, vc): logits[:,
        j] is the next-token distribution after input j (the speculative
        verify forward)."""
        rows = posv[:, None] + _arange(toks.shape[1], posv)

        def write(li, k, v):
            _scatter_chunk(kc, li, k, posv)
            _scatter_chunk(vc, li, v, posv)

        logits = self._forward_rows(params, toks, rows, write,
                                    lambda li: (kc[li], vc[li]), self._mask(positions, rows))
        return logits, kc, vc

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

    def _decode_loop(self, params, shape, dtype, device, top_k, has_top_p, do_sample,
                     width, forward):
        """The tensors and the step of one decode key, the step forwarding
        with ``forward`` (``_forward_one``, or ``_forward_one_ring`` when
        streaming).  The token buffer is ``width`` wide (max_len, or the
        stream's rope table length): the last step's token lands at
        n_steps <= width - 1 and is dropped, as in the JAX loop."""
        lp = self._loop_tensors(shape, dtype, device, do_sample)
        B = shape[1]
        lp.tokens = torch.zeros((B, width), dtype=torch.long, device=device)
        lp.temperature = torch.ones((), dtype=torch.float32, device=device)
        lp.top_p = torch.ones((), dtype=torch.float32, device=device) if has_top_p else None

        def step():
            tok = lp.tokens.index_select(1, lp.i.reshape(1)).reshape(B)
            logits, _, _ = forward(params, lp.kc, lp.vc, tok, lp.pos, lp.positions)
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
        temperature=None, top_k=None, top_p=None, do_sample=False, stream=False,
    ):
        """Decode ``n_steps`` steps from ``tok0`` at position ``pos0``: step
        i forwards token i and selects token i + 1, so the last step's
        selection falls outside the (B, n_steps) buffer, as in the JAX loop
        (which compiles one program per power-of-two bucket of ``n_steps``;
        one captured step replayed ``n_steps`` times needs no buckets).  The
        draw reads the decoder's generator (``_rng``).  ``params`` must be
        the decoder's prepared tree (``_prepared``).  ``stream`` forwards
        on the ring cache (``_forward_one_ring``), the key holding the
        rope table's length, which ``params`` carries.  Returns (tokens
        (B, n_steps) incl. tok0, the loop's caches)."""
        kc, vc = caches
        key = ("stream" if stream else "decode", tuple(kc.shape), kc.dtype, do_sample,
               top_k, top_p is not None)
        if stream:
            key += (self._rope_len,)
            width, forward = self._rope_len, self._forward_one_ring
        else:
            width, forward = kc.shape[3], self._forward_one
        lp = self._loop(key, lambda: self._decode_loop(
            params, kc.shape, kc.dtype, kc.device, top_k, top_p is not None, do_sample,
            width, forward))
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
        stream = plen + new_tokens > L
        if stream and not (
            self._stream_ok and self.window and self.window <= L and plen <= L
        ):
            raise ValueError(
                f"prompt_len {plen} + new_tokens {new_tokens} exceeds "
                f"max_len {L}; streaming decode needs a sliding-window "
                "Llama-family model (window <= max_len, prompt <= max_len)"
            )
        do_sample = temperature is not None and temperature > 0.0
        if not do_sample:
            temperature = top_k = top_p = None
        device = self.lm.tok_embed.weight.device
        with self._lock, torch.inference_mode():
            if stream:
                # the rope tables cover every absolute position generated,
                # their length a power of two (one graph key per length)
                self._rope_len = 1 << (plen + new_tokens - 1).bit_length()
            try:
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
                    temperature, top_k, top_p, do_sample, stream,
                )
                out = tokens.cpu().numpy()  # the one readback
            finally:
                self._rope_len = 0  # back to max_len tables for other calls
        return np.concatenate([idx, out.astype(idx.dtype)], 1)


class LlamaKVCacheDecoder(KVCacheDecoder):
    """KV-cache decoding for ``models.LlamaLM`` (RMSNorm, RoPE, GQA, SwiGLU).
    The cache is ``(layers, B, num_kv_heads, max_len, Dh)``; q/k/v fuse into
    one ``(E, E + 2·Hkv·Dh)`` matrix and gate/up into one ``(E, 2·hidden)``.
    RMSNorm's statistics and RoPE are computed in f32, the rope tables
    (``(n, Dh)`` f32, n = max_len or the stream's power-of-two length) kept
    per length apart from the prepared weights, so a graph's tables never
    move.  A sliding-window model streams past max_len
    (``_forward_one_ring``)."""

    _FUSED = {"qkv_w": ("q_w", "k_w", "v_w"), "gate_up_w": ("gate_w", "up_w")}
    _QUANT_KEYS = frozenset(("qkv_w", "o_w", "gate_up_w", "down_w"))
    _stream_ok = True

    def _block_tensors(self, blk):
        a = blk.attn
        return dict(
            ln1_w=blk.norm1.weight, q_w=a.q_proj.weight, k_w=a.k_proj.weight,
            v_w=a.v_proj.weight, o_w=a.out_proj.weight, ln2_w=blk.norm2.weight,
            gate_w=blk.gate.weight, up_w=blk.up.weight, down_w=blk.down.weight,
        )

    def _gather(self):
        lm = self.lm
        blocks = [{k: t.detach() for k, t in self._block_tensors(blk).items()}
                  for blk in lm.blocks]
        return dict(
            tok=lm.tok_embed.weight.detach(), blocks=blocks,
            lnf_w=lm.norm.weight.detach(), head_w=lm.head.weight.detach(),
        )

    def __init__(self, lm, compute_dtype=None, quant=None):
        super().__init__(lm, compute_dtype, quant)  # refuses an unmerged LoRA model first
        self._rope_tables = {}  # n_pos -> (cos, sin), kept while a graph may read them

    def _prepared(self):
        """The prepared weights with the rope tables of this call's length
        (max_len, or the stream's) beside them."""
        return self._with_rope(super()._prepared())

    def _with_rope(self, params):
        n_pos = max(self.lm.max_len, self._rope_len)
        tables = self._rope_tables.get(n_pos)
        if tables is None:
            a0 = self.lm.blocks[0].attn
            dev = params["tok"].device
            tables = tuple(t.to(dev) for t in rope_tables(n_pos, a0.head_dim, a0.rope_theta))
            self._rope_tables[n_pos] = tables
        return dict(params, rope_cos=tables[0], rope_sin=tables[1])

    # ------------------------------------------------------- pure pieces
    @staticmethod
    def _rms(x, w, eps):
        xf = x.float()  # stats in f32 even for bf16 compute
        ms = (xf * xf).mean(-1, keepdim=True)
        return (xf / torch.sqrt(ms + eps)).to(x.dtype) * w

    @staticmethod
    def _rope(x, cos, sin):
        """x (B, heads, T, D) with cos/sin (T, D) f32; applied in f32."""
        xf = x.float()
        half = x.shape[-1] // 2
        rot = torch.cat([-xf[..., half:], xf[..., :half]], -1)
        return (xf * cos + rot * sin).to(x.dtype)

    def _heads(self):
        a = self.lm.blocks[0].attn
        return a.num_heads, a.num_kv_heads, a.head_dim

    def _attn_proj(self, h, p, H):
        """h (B, T, E) -> q (B, H, T, D), k and v (B, Hkv, T, D) through the
        fused bias-free projection."""
        B, T, _ = h.shape
        _, Hkv, D = self._heads()
        q, k, v = _mm(h, p["qkv_w"]).split([H * D, Hkv * D, Hkv * D], -1)

        def sh(z, heads):
            return z.reshape(B, T, heads, D).transpose(1, 2)

        return sh(q, H), sh(k, Hkv), sh(v, Hkv)

    def _mlp(self, h, p):
        g, u = _mm(h, p["gate_up_w"]).chunk(2, -1)
        return _mm(torch.nn.functional.silu(g) * u, p["down_w"])

    # ----------------------------------------------------------- prefill
    def _prefill(self, params, prompt, plen):
        H, Hkv, D = self._heads()
        G = H // Hkv
        L = self.lm.max_len
        eps = self.lm.norm.eps
        scale = 1.0 / math.sqrt(D)
        x = params["tok"][prompt]
        B = x.shape[0]
        full = torch.full((L, L), -1e30, dtype=torch.float32, device=x.device)
        mask = torch.triu(full, 1)
        if self.window:
            mask = mask + torch.tril(full, -self.window)
        # the tables may reach past L for a stream; prefill covers [0, L)
        cos, sin = params["rope_cos"][:L], params["rope_sin"][:L]
        kc = torch.empty((len(params["blocks"]), B, Hkv, L, D), dtype=x.dtype, device=x.device)
        vc = torch.empty_like(kc)
        for li, p in enumerate(params["blocks"]):
            q, k, v = self._attn_proj(self._rms(x, p["ln1_w"], eps), p, H)
            q = self._rope(q, cos, sin)
            k = self._rope(k, cos, sin)
            kc[li] = k
            vc[li] = v
            # grouped products: each K/V head serves G query heads
            q5 = q.reshape(B, Hkv, G, L, D)
            s = self._scores(q5, k[:, :, None], scale) + mask
            attn = torch.softmax(s, -1).to(v.dtype)
            o = (attn @ v[:, :, None]).reshape(B, H, L, D).transpose(1, 2).reshape(B, L, H * D)
            x = x + _mm(o, p["o_w"])
            x = x + self._mlp(self._rms(x, p["ln2_w"], eps), p)
        x = self._rms(x, params["lnf_w"], eps)
        return kc, vc, self._head(x[:, plen - 1], params)

    # --------------------------------------------------- decode forwards
    def _mask(self, positions, rows):
        return _invalid_keys(positions, rows[:, None, None, :, None], self.window)

    def _forward_rows(self, params, tok, rows, write, read, invalid):
        """The base class's block loop for the family: the rope tables read
        at ``rows``, grouped products (each K/V head serves G query heads)
        on (N, Hkv, G, T, L) scores, the fused SwiGLU (Mixtral: the expert
        mixture) as the MLP."""
        H, Hkv, D = self._heads()
        G = H // Hkv
        eps = self.lm.norm.eps
        scale = 1.0 / math.sqrt(D)
        N, T = tok.shape
        at = rows.reshape(-1)
        # (N or 1, 1, T, D): index_select at the positions, JAX's dynamic_slice
        cos = params["rope_cos"].index_select(0, at).view(*rows.shape, D)[:, None]
        sin = params["rope_sin"].index_select(0, at).view(*rows.shape, D)[:, None]
        x = params["tok"].index_select(0, tok.reshape(-1)).view(N, T, -1)
        for li, p in enumerate(params["blocks"]):
            q, k_new, v_new = self._attn_proj(self._rms(x, p["ln1_w"], eps), p, H)
            q = self._rope(q, cos, sin)
            write(li, self._rope(k_new, cos, sin), v_new)  # (N, Hkv, T, D)
            k, v = read(li)
            s = self._scores(q.reshape(N, Hkv, G * T, D), k, scale)
            s = s.view(N, Hkv, G, T, -1).masked_fill(invalid, -1e30)
            attn = torch.softmax(s, -1).to(v.dtype).view(N, Hkv, G * T, -1)
            o = (attn @ v).view(N, H, T, D).transpose(1, 2).reshape(N, T, H * D)
            x = x + _mm(o, p["o_w"])
            x = x + self._mlp(self._rms(x, p["ln2_w"], eps), p)
        x = self._rms(x, params["lnf_w"], eps)
        return self._head(x.reshape(N * T, -1), params).view(N, T, -1)

    def _forward_one_ring(self, params, kc, vc, tok, pos, positions):
        """``_forward_one`` over a ring cache of C = max_len positions: the
        write lands at ``pos % C``, over absolute position pos - C, which a
        window <= C puts outside the band, and each slot's absolute
        position is rebuilt for the mask (slots not yet written come out
        negative).  Both are computed on the device."""
        C = kc.shape[3]
        slot = torch.remainder(pos, C).reshape(1)
        abs_pos = pos - torch.remainder(pos - positions, C)
        invalid = _invalid_keys(abs_pos, pos, self.window) | (abs_pos < 0)

        def write(li, k, v):
            kc[li].index_copy_(2, slot, k)
            vc[li].index_copy_(2, slot, v)

        logits = self._forward_rows(params, tok[:, None], pos.reshape(1, 1), write,
                                    lambda li: (kc[li], vc[li]), invalid)
        return logits[:, 0], kc, vc


class MixtralKVCacheDecoder(LlamaKVCacheDecoder):
    """KV-cache decoding for ``models.MixtralLM``: the Llama attention
    (GQA-narrow cache, RoPE, fused q/k/v) with the top-k-routed SwiGLU
    expert mixture as the FFN, every expert computed densely each step and
    the top-k combine masking the rest, as the JAX package does.  int8 and
    w8a8 apply to the attention and head matrices; the expert stacks stay
    in the compute dtype and the router's bias as it is (f32)."""

    _FUSED = {"qkv_w": ("q_w", "k_w", "v_w")}
    _QUANT_KEYS = frozenset(("qkv_w", "o_w"))
    _KEEP_KEYS = frozenset(("router_b",))

    def _block_tensors(self, blk):
        a, moe = blk.attn, blk.moe
        return dict(
            ln1_w=blk.norm1.weight, q_w=a.q_proj.weight, k_w=a.k_proj.weight,
            v_w=a.v_proj.weight, o_w=a.out_proj.weight, ln2_w=blk.norm2.weight,
            router_w=moe.router.weight, router_b=moe.router.bias,
            experts_gate=moe.experts_gate, experts_up=moe.experts_up,
            experts_down=moe.experts_down,
        )

    def _mlp(self, h, p):
        """Router softmax in f32, the top-k gates kept (every gate tied at
        the k-th too) and renormalised, all experts computed, the gated
        combine."""
        B, T, D = h.shape
        xf = h.reshape(B * T, D)
        logits = xf.float() @ p["router_w"].float() + p["router_b"]  # (N, E) f32
        gates = torch.softmax(logits, -1)
        k, E = self.lm.top_k, self.lm.n_experts
        if k and k < E:
            kth = torch.topk(gates, k, -1).values[..., -1:]
            kept = torch.where(gates >= kth, gates, 0.0)
            gates = kept / kept.sum(-1, keepdim=True)
        g = torch.nn.functional.silu(xf @ p["experts_gate"])  # (E, N, H)
        oe = (g * (xf @ p["experts_up"])) @ p["experts_down"]  # (E, N, D)
        out = torch.einsum("ne,end->nd", gates.to(oe.dtype), oe)
        return out.reshape(B, T, D).to(h.dtype)
