"""The port's beam search (``KVCacheDecoder.generate_beam``,
deepflows_tpu_torch/models/decoding.py) against the JAX package's, on the
CPU, where the beam step that a CUDA graph replays on the card runs eagerly.

The JAX loop (``_beam``) forwards the first generated token at position
plen + 1 (deepflows_tpu/models/decoding.py:788), one past the position
greedy decoding gives it; the port forwards it at plen.  So the reference
here is the JAX package's own ``_beam`` program called with plen - 1, which
puts every step at the port's positions.  Tokens must be equal and scores
within 1e-5 (f32, log-probs of about -3 a token summed over 6 tokens and
divided by the length).  Weights cross with ``load_jax_state_dict``;
prompts are numpy arrays from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.config import config as tconfig
from deepflows_tpu_torch.models import KVCacheDecoder, TransformerLM
from deepflows_tpu_torch.utils import load_jax_state_dict

CFG = dict(vocab_size=48, max_len=24, dim=32, depth=2, num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state and both packages'
    ``use_pallas`` as this module found them."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels

    seed, host_key, np_rng = config.seed, jax_kernels._host_key, numpy_kernels._rng
    np_state = np_rng.bit_generator.state
    eager = (jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter)
    pallas = (config.use_pallas, tconfig.use_pallas)
    yield
    config.seed, jax_kernels._host_key, numpy_kernels._rng = seed, host_key, np_rng
    np_rng.bit_generator.state = np_state
    jrandom._eager_key, jrandom._trace_key, jrandom._trace_counter = eager
    config.use_pallas, tconfig.use_pallas = pallas


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


@pytest.fixture(scope="module")
def models13():
    df.manual_seed(13)
    jlm = jmodels.TransformerLM(**CFG, device="tpu", flash=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return jlm, tlm


def _jax_beam(jlm, idx, new, num_beams, eos_id=None, length_penalty=1.0):
    """The JAX package's prefill and ``_beam`` program at the port's
    positions: (sequences (B, W, plen + new), scores (B, W))."""
    dec = JaxDecoder(jlm)
    B, plen = idx.shape
    prompt = np.zeros((B, CFG["max_len"]), np.int32)
    prompt[:, :plen] = idx
    params = dec._prep_jit(dec._gather())
    kc, vc, logits0 = dec._prefill_jit(params, jnp.asarray(prompt), plen)
    tokens, scores = dec._beam_jit(
        params, (kc, vc), logits0, np.int32(plen - 1), new, num_beams, eos_id,
        np.float32(length_penalty),
    )
    seqs = np.concatenate(
        [np.broadcast_to(idx[:, None], (B, num_beams, plen)), np.asarray(tokens)], 2
    )
    return seqs, np.asarray(scores)


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("num_beams", [1, 3, 4])
def test_generate_beam_matches_jax(models13, num_beams, eos):
    jlm, tlm = models13
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(num_beams).integers(0, 48, (2, 5)).astype(np.int64)
    # with eos: the token greedy decoding emits at its 3rd step, so beams finish
    eos_id = int(dec.generate(idx.copy(), 6)[0, 7]) if eos else None
    seqs, scores = dec.generate_beam(
        idx.copy(), 6, num_beams=num_beams, eos_id=eos_id, return_all=True
    )
    want_seqs, want_scores = _jax_beam(jlm, idx, 6, num_beams, eos_id)
    assert seqs.shape == (2, num_beams, 11) and seqs.dtype == idx.dtype
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)
    if eos:
        assert (seqs[..., 5:] == eos_id).any()


def test_return_all_is_best_first_and_length_penalty_matches_jax(models13):
    jlm, tlm = models13
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(8).integers(0, 48, (2, 4)).astype(np.int64)
    eos_id = int(dec.generate(idx.copy(), 5)[1, 5])
    seqs, scores = dec.generate_beam(
        idx.copy(), 5, num_beams=3, eos_id=eos_id, length_penalty=0.6, return_all=True
    )
    assert np.all(np.diff(scores, axis=1) <= 0)  # best-first
    np.testing.assert_array_equal(
        dec.generate_beam(idx.copy(), 5, num_beams=3, eos_id=eos_id, length_penalty=0.6),
        seqs[:, 0],
    )
    want_seqs, want_scores = _jax_beam(jlm, idx, 5, 3, eos_id, 0.6)
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_beam_is_greedy(seed):
    """num_beams=1 equals greedy generate(), the port's and the JAX
    package's, on models where the JAX package's own generate_beam, one
    position late, need not."""
    df.manual_seed(seed)
    jlm = jmodels.TransformerLM(**CFG, device="tpu", flash=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    idx = np.random.default_rng(seed).integers(0, 48, (3, 5)).astype(np.int64)
    dec = KVCacheDecoder(tlm)
    greedy = dec.generate(idx.copy(), 10)
    np.testing.assert_array_equal(dec.generate_beam(idx.copy(), 10, num_beams=1), greedy)
    np.testing.assert_array_equal(greedy, JaxDecoder(jlm).generate(idx.copy(), 10))


@pytest.mark.parametrize("quant", ["int8", "w8a8"])
def test_beam_search_quantised_bf16_composes(models13, quant):
    """As tests/test_decoding.py::test_beam_search_int8_bf16_compose: the
    quantised bf16 decoder's beams equal the dense f32 decoder's."""
    _, tlm = models13
    dense = KVCacheDecoder(tlm)
    qdec = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant=quant)
    idx = np.random.default_rng(12).integers(0, 48, (2, 5)).astype(np.int64)
    np.testing.assert_array_equal(
        qdec.generate_beam(idx.copy(), 5, num_beams=3),
        dense.generate_beam(idx.copy(), 5, num_beams=3),
    )


def test_beam_search_rejects_bad_args(models13):
    _, tlm = models13
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(3).integers(0, 48, (1, 4)).astype(np.int64)
    with pytest.raises(ValueError):
        dec.generate_beam(idx, 5, num_beams=0)
    with pytest.raises(ValueError):
        dec.generate_beam(idx, 0)
    with pytest.raises(ValueError):
        dec.generate_beam(idx, 100)
    with pytest.raises(ValueError):
        dec.generate_beam(np.zeros((1, 0), np.int64), 3)


def test_one_token_needs_no_step(models13):
    """new_tokens 1: the prefill's top W are the beams, and no step runs."""
    _, tlm = models13
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(4).integers(0, 48, (2, 3)).astype(np.int64)
    seqs, scores = dec.generate_beam(idx.copy(), 1, num_beams=2, return_all=True)
    with torch.inference_mode():
        prompt = torch.zeros((2, CFG["max_len"]), dtype=torch.long)
        prompt[:, :3] = torch.as_tensor(idx)
        _, _, logits = dec._prefill(dec._prep_tree(dec._gather()), prompt, 3)
        top = torch.topk(torch.log_softmax(logits, -1), 2)
    np.testing.assert_array_equal(seqs[:, :, 3], top.indices.numpy())
    np.testing.assert_array_equal(scores, top.values.numpy())
