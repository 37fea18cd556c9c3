"""The port's in-flight engine (deepflows_tpu_torch/models/engine.py), dense
and paged, with its prefix cache, on the CPU: the cases of the JAX
package's tests/test_engine.py and tests/test_engine_paged.py.

Staggered greedy requests through the engine give the JAX package's
one-shot ``KVCacheDecoder.generate`` tokens, for TransformerLM (dim 32,
depth 2, 2 heads) and LlamaLM (4 query and 2 K/V heads), max_len 32, in
f32 (weights cross with ``load_jax_state_dict``); the other cases hold the
engine against the port's own one-shot decoder, which the decoder tests
hold against JAX's.  On the CPU the engine's chunk runs its step eagerly:
the plain twin of the graph it replays on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.models import InflightEngine, KVCacheDecoder, LlamaLM, TransformerLM
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(23)
L = 32
CFG = {"gpt": dict(vocab_size=48, max_len=L, dim=32, depth=2, num_heads=2),
       "llama": dict(vocab_size=48, max_len=L, dim=32, depth=2, num_heads=4, num_kv_heads=2)}


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


def _pair(family, seed=5):
    df.manual_seed(seed)
    cls = {"gpt": (jmodels.TransformerLM, TransformerLM), "llama": (jmodels.LlamaLM, LlamaLM)}
    jcls, tcls = cls[family]
    jlm = jcls(**CFG[family], device="cpu", flash=False)
    tlm = tcls(**CFG[family], device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return jlm, tlm


@pytest.fixture(scope="module")
def gpt():
    return _pair("gpt")[1]


def _prompts(*lens):
    return [RNG.integers(0, 48, (n,)).astype(np.int64) for n in lens]


def _one_shot(lm, prompts, budgets):
    dec = KVCacheDecoder(lm)
    return [dec.generate(p[None], n)[0] for p, n in zip(prompts, budgets)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_staggered_requests_match_jax_one_shot(family, paged):
    """Three requests of prompts 3, 6 and 9 and budgets 10, 7 and 12 on two
    slots (the third queues behind a retirement) decode interleaved and
    give the JAX package's one-shot greedy tokens.  Paged: blocks of 8, a
    pool of 9; a drained engine has every block back and a zero table."""
    jlm, tlm = _pair(family, seed=5 if family == "gpt" else 7)
    prompts, budgets = _prompts(3, 6, 9), [10, 7, 12]
    jdec = JaxDecoder(jlm)
    wants = [jdec.generate(p[None].copy(), n)[0] for p, n in zip(prompts, budgets)]
    kw = dict(paged_blocks=9, block_size=8) if paged else {}
    with InflightEngine(tlm, slots=2, chunk=4, **kw) as eng:
        got = [h.result(timeout=120) for h in [eng.submit(p, n) for p, n in zip(prompts, budgets)]]
    for g, w, p in zip(got, wants, prompts):
        np.testing.assert_array_equal(g, w, err_msg=f"prompt len {p.size}")
    if paged:
        assert sorted(eng._free) == list(range(1, 10))
        assert (eng._tbl == 0).all()
        assert eng.stats["admit_prefill"] == 3 and eng.stats["chunks"] >= 3


def test_mid_flight_admission(gpt):
    """A request submitted while another is mid-decode joins the running
    batch; both finish with the one-shot tokens."""
    p1, p2 = _prompts(4, 6)
    w1, w2 = _one_shot(gpt, [p1, p2], [16, 6])
    with InflightEngine(gpt, slots=4, chunk=2) as eng:
        h1 = eng.submit(p1, 16)
        deadline = time.time() + 120
        while len(h1.tokens) < 4 and not h1.done():
            assert time.time() < deadline, "h1 never progressed"
            time.sleep(0.002)
        h2 = eng.submit(p2, 6)
        np.testing.assert_array_equal(h1.result(timeout=120), w1)
        np.testing.assert_array_equal(h2.result(timeout=120), w2)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eos_truncates_and_sampling_rides_along(gpt, paged):
    """eos_id stops a request at its first eos (kept) without disturbing
    the others; a sampled request (temperature 0.9, top_p 0.9, the engine's
    top_k 8) rides beside a greedy one, which stays exact, and is in the
    vocabulary at full length; paged, every block comes back."""
    (p,) = _prompts(5)
    (full,) = _one_shot(gpt, [p], [12])
    eos = int(full[5 + 3])
    stop = int(np.flatnonzero(full[5:] == eos)[0])
    kw = dict(paged_blocks=6, block_size=8) if paged else {}
    with InflightEngine(gpt, slots=2, chunk=5, top_k=8, **kw) as eng:
        np.testing.assert_array_equal(eng.submit(p, 12, eos_id=eos).result(120),
                                      full[: 5 + stop + 1])
        hs = eng.submit(p, 12, temperature=0.9, top_p=0.9)
        hg = eng.submit(p, 12)
        np.testing.assert_array_equal(hg.result(120), full)
        out = hs.result(120)
    assert out.shape == (17,) and ((out >= 0) & (out < 48)).all()
    if paged:
        assert sorted(eng._free) == list(range(1, 7))


def test_sampling_is_reproducible_under_the_engine_seed(gpt):
    """One engine-wide generator: the same seed and traffic give the same
    draws, another seed other draws."""
    (p,) = _prompts(4)
    outs = []
    for seed in (3, 3, 4):
        with InflightEngine(gpt, slots=2, chunk=4, seed=seed) as eng:
            outs.append(eng.generate(p, 12, temperature=1.0))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])


def test_queueing_from_threads(gpt):
    """Seven requests from seven threads on two slots all finish exact."""
    prompts = [RNG.integers(0, 48, (1 + i % 5,)).astype(np.int64) for i in range(7)]
    wants = _one_shot(gpt, prompts, [5] * 7)
    results = [None] * 7
    with InflightEngine(gpt, slots=2, chunk=3) as eng:
        def worker(i):
            results[i] = eng.submit(prompts[i], 5).result(timeout=180)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    for i, (g, w) in enumerate(zip(results, wants)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_single_token_and_validation(gpt):
    (p,) = _prompts(4)
    (want,) = _one_shot(gpt, [p], [1])
    with InflightEngine(gpt, slots=1, chunk=2) as eng:
        np.testing.assert_array_equal(eng.submit(p, 1).result(timeout=120), want)
        for bad in ((p, 0), (p[None], 3), (p, 100), (p[:0], 2)):
            with pytest.raises(ValueError):
                eng.submit(*bad)
        with pytest.raises(ValueError, match="non-empty"):
            eng.register_prefix([])
        with pytest.raises(ValueError, match="no room"):
            eng.register_prefix(np.zeros(L, np.int64))
    with pytest.raises(RuntimeError):
        eng.submit(p, 1)  # closed
    with pytest.raises(ValueError, match="divide"):
        InflightEngine(gpt, paged_blocks=4, block_size=7, start=False)
    with pytest.raises(ValueError, match=">= 1"):
        InflightEngine(gpt, paged_blocks=0, block_size=8, start=False)
    with pytest.raises(ValueError, match=">= 1"):
        InflightEngine(gpt, slots=0, start=False)


def test_refresh_params_reads_weights_changed_in_place():
    """A weight changed in place, then refresh_params(): the engine's
    tokens follow the new weights (a fresh decoder's), through the same
    prepared tensors its steps read."""
    _, lm = _pair("gpt", seed=29)
    (p,) = _prompts(4)
    with InflightEngine(lm, slots=1, chunk=4) as eng:
        before = eng.submit(p, 8).result(timeout=120)
        head = eng.params["head_w"]
        with torch.no_grad():
            lm.head.weight.mul_(-1.0)
        eng.refresh_params()
        after = eng.submit(p, 8).result(timeout=120)
        assert eng.params["head_w"] is head  # copied into, not replaced
    want = KVCacheDecoder(lm).generate(p[None], 8)[0]
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, want)


def test_prefix_cache_exact_and_counted(gpt):
    """Prompts sharing a registered prefix of 9 give the tokens without a
    prefix cache, over suffixes of 0 (the prompt is the prefix), 1, 2, 5
    and 15 (buckets 1 to 16); a prefix of 20 with a suffix of 9 takes the
    capped bucket (12 = max_len - 20), its window ending at max_len - 1.
    Hits, misses and the admission counts tally."""
    prefix = RNG.integers(0, 48, (9,)).astype(np.int64)
    long_prefix = RNG.integers(0, 48, (20,)).astype(np.int64)
    prompts = [np.concatenate([prefix, RNG.integers(0, 48, (s,))]).astype(np.int64)
               for s in (0, 1, 2, 5, 15)]
    budgets = [8] * 5
    prompts.append(np.concatenate([long_prefix, RNG.integers(0, 48, (9,))]))
    budgets.append(L - 29)
    wants = _one_shot(gpt, prompts, budgets)
    with InflightEngine(gpt, slots=2, chunk=4) as eng:
        eng.register_prefix(prefix)
        eng.register_prefix(long_prefix)
        assert eng._suffix_bucket(9, 20) == 12
        got = [eng.generate(p, n) for p, n in zip(prompts, budgets)]
        assert eng.prefix_hits == 6 and eng.prefix_misses == 0
        assert eng.stats["admit_full_hit"] == 1 and eng.stats["admit_suffix"] == 5
        eng.generate(RNG.integers(0, 48, (4,)).astype(np.int64), 4)  # unrelated: a miss
        assert eng.prefix_misses == 1 and eng.stats["admit_prefill"] == 1
    for g, w, p in zip(got, wants, prompts):
        np.testing.assert_array_equal(g, w, err_msg=f"prompt {p.size}")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefix_longest_match_llama(paged):
    """Nested registered prefixes: the longest wins, for the Llama decoder
    (rope at the suffix's positions) too, dense and paged."""
    jlm, lm = _pair("llama", seed=7)
    p_short = RNG.integers(0, 48, (4,)).astype(np.int64)
    p_long = np.concatenate([p_short, RNG.integers(0, 48, (6,))])
    prompt = np.concatenate([p_long, RNG.integers(0, 48, (3,))])
    want = JaxDecoder(jlm).generate(prompt[None].copy(), 8)[0]
    kw = dict(paged_blocks=8, block_size=8) if paged else {}
    with InflightEngine(lm, slots=2, chunk=4, **kw) as eng:
        eng.register_prefix(p_short)
        eng.register_prefix(p_long)
        got = eng.generate(prompt, 8)
        assert eng._match_prefix(prompt) == tuple(int(t) for t in p_long)
    np.testing.assert_array_equal(got, want)


def test_prefix_lru_and_refresh_invalidation():
    """Beyond max_prefixes the least recently used entry goes; after
    refresh_params() a prefix's K/V are computed from the new weights."""
    _, lm = _pair("gpt", seed=31)
    prefix = RNG.integers(0, 48, (6,)).astype(np.int64)
    prompt = np.concatenate([prefix, RNG.integers(0, 48, (3,))]).astype(np.int64)
    with InflightEngine(lm, slots=2, chunk=4, max_prefixes=2) as eng:
        firsts = [RNG.integers(0, 48, (5 + i,)).astype(np.int64) for i in range(4)]
        for f in firsts:
            eng.register_prefix(f)
        assert len(eng._prefixes) == 2
        assert tuple(int(t) for t in firsts[0]) not in eng._prefixes
        eng.register_prefix(prefix)
        before = eng.generate(prompt, 6)
        with torch.no_grad():
            for p in lm.parameters():
                p.mul_(1.5)
        eng.refresh_params()
        after = eng.generate(prompt, 6)
        assert eng.prefix_hits == 2
    np.testing.assert_array_equal(after, KVCacheDecoder(lm).generate(prompt[None], 6)[0])
    assert not np.array_equal(before, after)


def test_paged_backpressure_and_memory(gpt):
    """A pool too small for two requests at once (each needs 2 blocks of
    8, the pool has 3) still completes both: the second admission waits
    for the first's blocks.  A 4-slot engine with a pool of 6 blocks holds
    under half the dense engine's cache memory."""
    p1, p2 = _prompts(6, 5)
    w1, w2 = _one_shot(gpt, [p1, p2], [10, 10])
    with InflightEngine(gpt, slots=2, chunk=4, paged_blocks=3, block_size=8) as eng:
        h1, h2 = eng.submit(p1, 10), eng.submit(p2, 10)
        np.testing.assert_array_equal(h1.result(timeout=120), w1)
        np.testing.assert_array_equal(h2.result(timeout=120), w2)
    assert sorted(eng._free) == [1, 2, 3]
    dense = InflightEngine(gpt, slots=4, chunk=4, start=False)
    paged = InflightEngine(gpt, slots=4, chunk=4, paged_blocks=6, block_size=8, start=False)
    assert paged.cache_bytes() < 0.5 * dense.cache_bytes()
