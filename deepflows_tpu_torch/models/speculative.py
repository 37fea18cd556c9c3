"""Speculative decoding (counterpart of ``SpeculativeDecoder`` in
``deepflows_tpu/models/speculative.py``): a small DRAFT model proposes
``gamma`` tokens, the TARGET scores them all in one chunk forward
(``KVCacheDecoder._forward_chunk``), a leading run of proposals is
accepted and one corrected or bonus token comes from the target
(arXiv:2211.17192, 2302.01318).  The output follows the target exactly:

- greedy: proposals are accepted while they equal the target's argmax, and
  the first mismatch is replaced by it, so the tokens are the target's own
  greedy tokens for any draft;
- sampled: proposal x is accepted with probability min(1, p(x) / q(x));
  on a rejection the token is drawn from normalize(max(p - q, 0)), and when
  all gamma survive the bonus is drawn from p.

JAX runs a whole generation as one ``lax.while_loop``.  The port captures
one ROUND (gamma draft ``_forward_multi`` steps and one more that writes
the last proposal's K/V, the target's verify
``_forward_chunk`` over B x (gamma + 1) rows, acceptance, and the masked
commit into the token buffer) in a CUDA graph on the card and replays it;
between batches of rounds the host reads one value, the least count of
committed tokens, so it knows when every row is done.  Rows that are done
spin harmlessly (their position pinned at 0, their commits masked).  Every
draw comes from the decoder's ``torch.Generator``, seeded by ``seed``.

The draft and target may be of different families (a GPT-style draft for
a Llama target); they share one vocabulary.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import torch

from ..jit import StepGraphs
from .decoding import KVCacheDecoder, _categorical

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    def __init__(self, target, draft, gamma: int = 4, compute_dtype=None, quant=None,
                 draft_compute_dtype=None):
        """``target`` and ``draft``: TransformerLM, LlamaLM or MixtralLM
        models of one vocabulary; ``gamma`` proposals a round.  ``quant``
        applies to the target only."""
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        tv, dv = target.head.weight.shape[-1], draft.head.weight.shape[-1]
        if tv != dv:
            raise ValueError(f"target and draft must share a vocabulary (got {tv} vs {dv})")
        self.gamma = int(gamma)
        self.target = KVCacheDecoder(target, compute_dtype=compute_dtype, quant=quant)
        self.draft = KVCacheDecoder(draft, compute_dtype=draft_compute_dtype or compute_dtype)
        self.last_stats = None
        self._loops = {}  # graph key -> the round's tensors and step
        self._graphs = StepGraphs()
        self._generator = None
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- round
    def _round_loop(self, tp, dp, tshape, dshape, dtype, ddtype, device, do_sample):
        """The tensors one round reads and writes, and the round itself."""
        g = self.gamma
        B = tshape[1]
        lp = SimpleNamespace(
            tkc=torch.zeros(tshape, dtype=dtype, device=device),
            tvc=torch.zeros(tshape, dtype=dtype, device=device),
            dkc=torch.zeros(dshape, dtype=ddtype, device=device),
            dvc=torch.zeros(dshape, dtype=ddtype, device=device),
            pos_t=torch.arange(tshape[3], device=device),
            pos_d=torch.arange(dshape[3], device=device),
            # the buffer holds max_len tokens and a round's overshoot
            tokens=torch.zeros((B, tshape[3] + g + 1), dtype=torch.long, device=device),
            counts=torch.zeros(B, dtype=torch.long, device=device),
            posv=torch.zeros(B, dtype=torch.long, device=device),
            cur=torch.zeros(B, dtype=torch.long, device=device),
            n_new=torch.zeros((), dtype=torch.long, device=device),
            temp=torch.ones((), dtype=torch.float32, device=device),
            rounds=torch.zeros((), dtype=torch.long, device=device),
            accepted=torch.zeros((), dtype=torch.long, device=device),
            samples=do_sample,
        )
        cap = lp.tokens.shape[1]
        rows = torch.arange(B, device=device)

        def soft(logits):
            return torch.softmax(logits.float() / lp.temp.clamp_min(1e-6), -1)

        def draw(probs):
            return _categorical(torch.log(probs.clamp_min(1e-30)), self._generator)

        def step():
            done = lp.counts >= lp.n_new
            # rows that are done spin at position 0: their writes stay in
            # bounds, their commits are masked
            posv = torch.where(done, 0, lp.posv)
            t, pv = lp.cur, posv
            d_toks, d_probs = [], []
            for _ in range(g):  # the draft proposes
                dlog, _, _ = self.draft._forward_multi(dp, lp.dkc, lp.dvc, t, pv, lp.pos_d)
                if do_sample:
                    q = soft(dlog)
                    t = draw(q)
                    d_probs.append(q)
                else:
                    t = dlog.argmax(-1)
                d_toks.append(t)
                pv = pv + 1
            # d_g's K/V too, so the draft's cache holds every token a round
            # may accept (JAX's leaves that position stale after a round
            # that accepts all gamma)
            self.draft._forward_multi(dp, lp.dkc, lp.dvc, t, pv, lp.pos_d)
            d_toks = torch.stack(d_toks, 1)  # (B, g)
            chunk = torch.cat([lp.cur[:, None], d_toks], 1)  # (B, g + 1)
            tlog, _, _ = self.target._forward_chunk(tp, lp.tkc, lp.tvc, chunk, posv, lp.pos_t)
            if do_sample:
                p_all = soft(tlog)  # (B, g + 1, V)
                q_all = torch.stack(d_probs, 1)  # (B, g, V)
                pd = p_all[:, :g].gather(2, d_toks[:, :, None])[..., 0]
                qd = q_all.gather(2, d_toks[:, :, None])[..., 0]
                u = torch.rand((B, g), generator=self._generator, device=device)
                acc = u < pd / qd.clamp_min(1e-30)
            else:
                acc = d_toks == tlog[:, :g].argmax(-1)
            acc_len = acc.long().cumprod(1).sum(1)  # the leading run of acceptances
            l_at = tlog.gather(1, acc_len[:, None, None].expand(B, 1, tlog.shape[2]))[:, 0]
            if do_sample:
                p_at = soft(l_at)
                q_at = q_all.gather(
                    1, acc_len.clamp_max(g - 1)[:, None, None].expand(B, 1, q_all.shape[2]))[:, 0]
                resid = (p_at - q_at).clamp_min(0.0)
                rs = resid.sum(-1, keepdim=True)
                resid = torch.where(rs > 1e-30, resid / rs, p_at)
                x_tok = draw(torch.where((acc_len >= g)[:, None], p_at, resid))
            else:
                x_tok = l_at.argmax(-1)
            for j in range(g + 1):  # commit d_1 .. d_acc_len, then x_tok
                val = torch.where(j < acc_len, d_toks[:, min(j, g - 1)], x_tok)
                col = (lp.counts + j).clamp(0, cap - 1)
                write = (j <= acc_len) & ~done
                old = lp.tokens[rows, col]
                lp.tokens[rows, col] = torch.where(write, val, old)
            adv = torch.where(done, 0, acc_len + 1)
            lp.counts.add_(adv)
            lp.posv.add_(adv)
            lp.cur.copy_(torch.where(done, lp.cur, x_tok))
            lp.rounds.add_((~done).any().long())  # JAX's loop stops when every row is done
            lp.accepted.add_(torch.where(done, 0, acc_len).sum())

        lp.step = step
        return lp

    def _run(self, key, lp, times):
        if lp.tkc.is_cuda:
            self._graphs.run(key, lp.step, times, (self._generator,) if lp.samples else ())
        else:
            for _ in range(times):
                lp.step()

    # ----------------------------------------------------------------- public
    def generate(self, idx, new_tokens: int, temperature: float = 0.0, seed: int = 0,
                 eos_id=None):
        """Speculatively decode ``new_tokens`` continuations of the (B, L)
        prompt; returns the (B, L + new_tokens) numpy array, as
        ``KVCacheDecoder.generate`` (greedy: the same tokens).  ``top_k``
        and ``top_p`` are not offered (the acceptance ratio needs the whole
        distributions).  ``eos_id`` pads each row after its first eos with
        eos.  ``last_stats`` records the rounds and the accepted share."""
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        idx = np.asarray(idx)
        B, plen = idx.shape
        if plen < 1:
            raise ValueError("prompt must have at least one token")
        g = self.gamma
        for name, lm in (("target", self.target.lm), ("draft", self.draft.lm)):
            if plen + new_tokens + g > lm.max_len:
                raise ValueError(
                    f"prompt {plen} + new_tokens {new_tokens} + gamma {g} exceeds the {name} "
                    f"max_len {lm.max_len} (the verify window needs gamma slack)")
        if new_tokens <= 0:
            return idx
        do_sample = temperature is not None and temperature > 0.0
        device = self.target.lm.tok_embed.weight.device
        with self._lock, torch.inference_mode():
            tp, dp = self.target._prepared(), self.draft._prepared()
            pre = {}
            for name, dec, params in (("t", self.target, tp), ("d", self.draft, dp)):
                prompt = torch.zeros((B, dec.lm.max_len), dtype=torch.long)
                prompt[:, :plen] = torch.as_tensor(idx, dtype=torch.long)
                pre[name] = dec._prefill(params, prompt.to(device), plen)
            tkc, tvc, tlog0 = pre["t"]
            dkc, dvc, _ = pre["d"]
            if self._generator is None:
                self._generator = torch.Generator(device=device)
            self._generator.manual_seed(seed)
            tok0 = self.target._select(tlog0, self._generator, temperature if do_sample else None,
                                       None, None, do_sample)
            key = ("spec", tuple(tkc.shape), tkc.dtype, tuple(dkc.shape), dkc.dtype, do_sample)
            lp = self._loops.get(key)
            if lp is None:
                lp = self._loops[key] = self._round_loop(tp, dp, tkc.shape, dkc.shape, tkc.dtype,
                                                         dkc.dtype, device, do_sample)
            for dst, src in ((lp.tkc, tkc), (lp.tvc, tvc), (lp.dkc, dkc), (lp.dvc, dvc)):
                dst.copy_(src)
            del pre, tkc, tvc, dkc, dvc
            lp.tokens.zero_()
            lp.tokens[:, 0] = tok0
            lp.cur.copy_(tok0)
            lp.counts.fill_(1)
            lp.posv.fill_(plen)
            lp.n_new.fill_(new_tokens)
            lp.temp.fill_(temperature if do_sample else 1.0)
            lp.rounds.zero_()
            lp.accepted.zero_()
            # a round commits 1 to gamma + 1 tokens a row: replay the fewest
            # rounds that could finish, then read the least count and go on
            least, run = 1, 0
            while least < new_tokens:
                times = -(-(new_tokens - least) // (g + 1))
                self._run(key, lp, times)
                run += times
                least = int(lp.counts.min())
            out = lp.tokens[:, :new_tokens].cpu().numpy()
            r, acc = int(lp.rounds), int(lp.accepted)
        self.last_stats = {
            "rounds": r,
            "rounds_run": run,  # replayed, the rounds after every row was done included
            "accepted": acc,
            "acceptance_rate": acc / max(r * B * g, 1),
            "tokens_per_round": (B * new_tokens - B) / max(r * B, 1) + 1,
        }
        out = out.astype(idx.dtype)
        if eos_id is not None:
            for b in range(B):
                hits = np.where(out[b] == eos_id)[0]
                if hits.size:
                    out[b, hits[0] + 1:] = eos_id
        return np.concatenate([idx, out], 1)
