"""The port's speculative decoder (deepflows_tpu_torch/models/speculative.py)
on the CPU: the cases of the JAX package's tests/test_speculative.py, and a
test of its claim that sampled output follows the target exactly.

Greedy output equals the target's own one-shot ``generate`` for any draft:
a random GPT-style draft (whose tokens are also held against the JAX
package's one-shot decoder on the same weights), the target itself, a GPT
draft for a Llama target, gamma 1.  The verify forward equals sequential
one-token steps.  Sampled output is reproducible under its seed, in the
vocabulary, and distributed as the target's: a chi-square test of the
first two generated tokens of 6,000 rows of one prompt, at vocabulary 8,
against the target's exact joint distribution.  On the CPU a round runs
eagerly: the plain twin of the graph it replays on the card.
"""

import numpy as np
import pytest
import torch
from scipy import stats

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.models import (
    KVCacheDecoder,
    LlamaLM,
    SpeculativeDecoder,
    TransformerLM,
)
from deepflows_tpu_torch.utils import load_jax_state_dict

V = 61


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it: later test files in the same process build their models from it."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = config.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    yield
    config.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager


@pytest.fixture(autouse=True)
def _clean():
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    ops.reset_launch_counts()
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _pair(jcls, tcls, seed, **cfg):
    df.manual_seed(seed)
    jlm = jcls(**cfg, device="cpu", flash=False)
    tlm = tcls(**cfg, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return jlm, tlm


@pytest.fixture(scope="module")
def lms():
    """Target TransformerLM (dim 48, depth 3), draft TransformerLM (dim 24,
    depth 1) and a Llama target (4 query, 2 K/V heads), max_len 48, and
    the JAX target."""
    jtarget, target = _pair(jmodels.TransformerLM, TransformerLM, 0, vocab_size=V, dim=48,
                            depth=3, num_heads=4, max_len=48)
    _, draft = _pair(jmodels.TransformerLM, TransformerLM, 7, vocab_size=V, dim=24, depth=1,
                     num_heads=2, max_len=48)
    _, llama = _pair(jmodels.LlamaLM, LlamaLM, 11, vocab_size=V, dim=48, depth=2, num_heads=4,
                     num_kv_heads=2, max_len=48)
    return target, draft, llama, jtarget


def _prompt(b=2, n=4, seed=1):
    return np.random.RandomState(seed).randint(0, V, (b, n)).astype(np.int64)


def test_greedy_equals_generate_random_draft_and_jax(lms):
    target, draft, _, jtarget = lms
    prompt = _prompt()
    ref = KVCacheDecoder(target).generate(prompt, 14)
    np.testing.assert_array_equal(ref, JaxDecoder(jtarget).generate(prompt.copy(), 14))
    spec = SpeculativeDecoder(target, draft, gamma=4)
    np.testing.assert_array_equal(spec.generate(prompt, 14), ref)
    assert spec.last_stats["rounds"] >= 1


def test_greedy_self_draft_accepts_and_saves_rounds(lms):
    target, _, _, _ = lms
    prompt = _prompt()
    ref = KVCacheDecoder(target).generate(prompt, 16)
    spec = SpeculativeDecoder(target, target, gamma=4)
    np.testing.assert_array_equal(spec.generate(prompt, 16), ref)
    st = spec.last_stats
    assert st["rounds"] < 16 and st["accepted"] > 0
    assert st["acceptance_rate"] > 0.9, st


@pytest.mark.parametrize("draft_kind,gamma", [("gpt", 3), ("self", 3), ("gpt", 1)])
def test_greedy_llama_target(lms, draft_kind, gamma):
    """A GPT draft for the Llama target, the Llama target as its own draft,
    and gamma 1."""
    _, draft, llama, _ = lms
    prompt = _prompt(n=3, seed=5)
    ref = KVCacheDecoder(llama).generate(prompt, 12)
    spec = SpeculativeDecoder(llama, draft if draft_kind == "gpt" else llama, gamma=gamma)
    np.testing.assert_array_equal(spec.generate(prompt, 12), ref)


def test_sampling_reproducible_in_range_and_eos(lms):
    target, draft, _, _ = lms
    prompt = _prompt()
    spec = SpeculativeDecoder(target, draft, gamma=3)
    a = spec.generate(prompt, 10, temperature=0.9, seed=4)
    np.testing.assert_array_equal(a, spec.generate(prompt, 10, temperature=0.9, seed=4))
    assert a.shape == (2, 14) and ((a >= 0) & (a < V)).all()
    assert not np.array_equal(a, spec.generate(prompt, 10, temperature=0.9, seed=5))
    base = spec.generate(prompt, 12)
    eos = int(base[0, 6])
    row = spec.generate(prompt, 12, eos_id=eos)[0, 4:]
    hits = np.flatnonzero(row == eos)
    assert hits.size and (row[hits[0]:] == eos).all()


def test_validation_errors(lms):
    target, draft, _, _ = lms
    other = TransformerLM(vocab_size=V + 1, dim=24, depth=1, num_heads=2, max_len=48,
                          device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeDecoder(target, other)
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeDecoder(target, draft, gamma=0)
    spec = SpeculativeDecoder(target, draft, gamma=4)
    with pytest.raises(ValueError, match="max_len"):
        spec.generate(_prompt(), 41)  # 4 + 41 + 4 > 48
    with pytest.raises(ValueError, match="at least one token"):
        spec.generate(np.zeros((2, 0), np.int64), 4)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_chunk_forward_matches_sequential(lms, family):
    """The verify forward of 3 tokens a row equals 3 one-token steps:
    logits and the caches they leave."""
    target, _, llama, _ = lms
    dec = KVCacheDecoder(target if family == "gpt" else llama)
    prompt = _prompt(seed=3)
    Lm = dec.lm.max_len
    pad = torch.zeros((2, Lm), dtype=torch.long)
    pad[:, :4] = torch.as_tensor(prompt)
    toks = torch.as_tensor(np.random.RandomState(0).randint(0, V, (2, 3)))
    positions = torch.arange(Lm)
    with torch.inference_mode():
        params = dec._prepared()
        kc, vc, _ = dec._prefill(params, pad, 4)
        kc1, vc1 = kc.clone(), vc.clone()
        seq = [dec._forward_one(params, kc1, vc1, toks[:, j], torch.tensor(4 + j), positions)[0]
               for j in range(3)]
        chunk, _, _ = dec._forward_chunk(params, kc, vc, toks, torch.full((2,), 4), positions)
    for j in range(3):
        torch.testing.assert_close(chunk[:, j], seq[j], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(kc, kc1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vc, vc1, rtol=1e-5, atol=1e-5)


def test_sampled_tokens_follow_the_target():
    """Vocabulary 8, a random draft unlike the target, temperature 1,
    gamma 2: 6,000 rows of one prompt, two tokens each.  The first comes
    from the target's prefill, the second through acceptance or the
    residual draw.  Their joint counts against N p(a) p(b | a) from the
    target's own forward: chi-square over the 64 cells, p above 1e-3 (the
    seed is fixed).  The draft is accepted on some rows and rejected on
    others, so both branches are drawn."""
    torch.manual_seed(0)
    cfg = dict(vocab_size=8, max_len=16, dim=16, num_heads=2)
    _, target = _pair(jmodels.TransformerLM, TransformerLM, 21, depth=2, **cfg)
    _, draft = _pair(jmodels.TransformerLM, TransformerLM, 22, depth=1, **cfg)
    prompt = np.array([3, 1, 4], np.int64)
    N = 6000
    spec = SpeculativeDecoder(target, draft, gamma=2)
    out = spec.generate(np.broadcast_to(prompt, (N, 3)).copy(), 2, temperature=1.0, seed=7)
    assert 0.1 < spec.last_stats["acceptance_rate"] < 0.95, spec.last_stats
    dec = KVCacheDecoder(target)
    with torch.inference_mode():
        params = dec._prepared()
        pad = torch.zeros((9, 16), dtype=torch.long)
        pad[:, :3] = torch.as_tensor(prompt)
        pad[1:, 3] = torch.arange(8)
        p1 = torch.softmax(dec._prefill(params, pad[:1], 3)[2][0], -1)
        p2 = torch.softmax(dec._prefill(params, pad[1:], 4)[2], -1)  # (a, b)
    expected = (N * p1[:, None] * p2).double().numpy().ravel()
    observed = np.bincount(out[:, 3] * 8 + out[:, 4], minlength=64)
    assert observed.sum() == N and expected.min() > 5
    chi2 = ((observed - expected) ** 2 / expected).sum()
    assert stats.chi2.sf(chi2, 63) > 1e-3, chi2
