"""The port's ``LlamaKVCacheDecoder`` (deepflows_tpu_torch/models/decoding.py)
against the JAX package's, on the CPU: a sliding-window GQA Llama (dim 32,
depth 2, 4 query and 2 K/V heads, window 4, max_len 16) in quant None /
"int8" / "w8a8" by compute dtype f32 / bf16.  The JAX side runs its Pallas
kernels in interpret mode, the port its kernels' plain twins; the port's
decode step, which a CUDA graph replays on the card, runs eagerly here.

Weights cross with ``load_jax_state_dict``; prompts are numpy arrays from a
seed.  Prefill logits: f32 within rtol and atol 1e-4; bf16 within the JAX
tests' bound, max |Δ| / max(1, |ref|) < 0.1 (tests/test_decoding.py).
Tokens are compared on prompts whose f32 greedy path keeps a top-1 minus
top-2 logit margin of at least 0.05 at every step.  Beam search is held
against the JAX package's ``_beam`` program called with plen - 1: the JAX
loop starts one position late (deepflows_tpu/models/decoding.py:788), for
the Llama decoder as for TransformerLM's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.models import KVCacheDecoder, LlamaKVCacheDecoder, LlamaLM
from deepflows_tpu_torch.utils import load_jax_state_dict

CFG = dict(vocab_size=48, max_len=16, dim=32, depth=2, num_heads=4, num_kv_heads=2,
           window=4)
QUANTS = [None, "int8", "w8a8"]
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


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
    ops.reset_launch_counts()
    df.set_grad_enabled(True)  # an earlier file's JAX Module.eval() may have left it off
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


def _pair(seed, **kw):
    df.manual_seed(seed)
    cfg = dict(CFG, **kw)
    jlm = jmodels.LlamaLM(**cfg, device="tpu", flash=False)
    tlm = LlamaLM(**cfg, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return jlm, tlm


@pytest.fixture(scope="module")
def models():
    return _pair(13)


@pytest.fixture(scope="module")
def prompts(models):
    """Two prompts of 6 whose f32 greedy path over 8 steps keeps every
    top-1 minus top-2 logit margin at 0.05 or more."""
    jlm, _ = models
    cand = np.random.default_rng(31).integers(0, 48, (32, 6)).astype(np.int64)
    seq = JaxDecoder(jlm).generate(cand.copy(), 8)
    pad = np.zeros((32, CFG["max_len"]), np.int64)
    pad[:, : seq.shape[1]] = seq
    with df.no_grad():
        logits = jlm(Tensor(pad, device="tpu")).numpy()[:, 5:13]
    top2 = np.sort(logits, -1)[..., -2:]
    keep = np.where((top2[..., 1] - top2[..., 0]).min(-1) >= 0.05)[0]
    Graph.free_graph_all()
    assert len(keep) >= 2
    return cand[keep[:2]]


def _padded(idx):
    prompt = np.zeros((idx.shape[0], CFG["max_len"]), np.int32)
    prompt[:, : idx.shape[1]] = idx
    return prompt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_logits_and_greedy_tokens_match_jax(models, prompts, quant, dtype):
    jlm, tlm = models
    jdt, tdt = DTYPES[dtype]
    jdec = JaxDecoder(jlm, compute_dtype=jdt, quant=quant)
    tdec = KVCacheDecoder(tlm, compute_dtype=tdt, quant=quant)
    assert type(tdec) is LlamaKVCacheDecoder and tdec.window == 4
    B, plen = prompts.shape
    prompt = _padded(prompts)
    jk, jv, jlg = jdec._prefill_jit(jdec._prep_jit(jdec._gather()), jnp.asarray(prompt), plen)
    with torch.inference_mode():
        tk, tv, tlg = tdec._prefill(tdec._prepared(), torch.as_tensor(prompt).long(), plen)
    assert tlg.dtype == torch.float32 and tlg.shape == (B, CFG["vocab_size"])
    assert tk.shape == tuple(jk.shape) == (2, B, 2, CFG["max_len"], 8)  # Hkv wide
    jlg = np.asarray(jlg)
    if dtype == "f32":
        np.testing.assert_allclose(tlg.numpy(), jlg, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    else:
        assert tk.dtype == torch.bfloat16
        err = np.abs(tlg.numpy() - jlg) / np.maximum(1.0, np.abs(jlg))
        assert err.max() < 0.1, err.max()
    want = jdec.generate(prompts.copy(), 8)
    np.testing.assert_array_equal(tdec.generate(prompts.copy(), 8), want)


@pytest.mark.parametrize("quant", QUANTS)
def test_prep_tree_fuses_and_quantises_every_matrix(models, quant):
    """q/k/v fuse into (E, E + 2·Hkv·Dh) and gate/up into (E, 2·hidden); under
    int8 and w8a8 the MLP's matrices are quantised too; the rope tables
    stay f32."""
    _, tlm = models
    dec = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant=quant)
    p = dec._prepared()
    blk = p["blocks"][0]
    hidden = tlm.blocks[0].gate.weight.shape[1]
    assert set(blk) == {"ln1_w", "ln2_w", "qkv_w", "o_w", "gate_up_w", "down_w"}
    assert p["rope_cos"].dtype == p["rope_sin"].dtype == torch.float32
    assert p["rope_cos"].shape == (CFG["max_len"], 8)
    assert p["tok"].dtype == blk["ln1_w"].dtype == torch.bfloat16
    if quant is None:
        assert blk["qkv_w"].shape == (32, 32 + 2 * 2 * 8)
        assert blk["gate_up_w"].shape == (32, 2 * hidden)
        return
    key = "w8a8" if quant == "w8a8" else "q"
    for w in (blk["qkv_w"], blk["o_w"], blk["gate_up_w"], blk["down_w"], p["head_w"]):
        assert set(w) == {key, "s"} and w[key].dtype == torch.int8
    assert blk["gate_up_w"]["s"].shape == (2 * hidden,)


@pytest.mark.parametrize("pos", [0, 5, CFG["max_len"] - 1])
def test_device_pos_step_matches_jax_forward_one(models, pos):
    """The capturable step (0-d device position, rope rows by index_select,
    the cache written by index_copy_ at the K/V heads' width) against the
    JAX step, the window cutting the band at positions 5 and 15."""
    jlm, tlm = models
    jdec, tdec = JaxDecoder(jlm), KVCacheDecoder(tlm)
    rng = np.random.default_rng(pos)
    L, plen = CFG["max_len"], 4
    prompt = _padded(rng.integers(0, 48, (3, plen)))
    tok = rng.integers(0, 48, (3,))
    jparams = jdec._prep_jit(jdec._gather())
    jk, jv, _ = jdec._prefill_jit(jparams, jnp.asarray(prompt), plen)
    jlg, jk, jv = jdec._forward_one(jparams, jk, jv, jnp.asarray(tok, jnp.int32), pos,
                                    jnp.arange(L))
    with torch.inference_mode():
        params = tdec._prepared()
        tk, tv, _ = tdec._prefill(params, torch.as_tensor(prompt).long(), plen)
        before = tk.clone()
        at = torch.tensor(pos)
        tlg, tk2, tv2 = tdec._forward_one(params, tk, tv, torch.as_tensor(tok), at,
                                          torch.arange(L))
    assert at.dim() == 0 and tk2 is tk and tv2 is tv
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=1e-5)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got[:, :, :, pos].numpy(), np.asarray(want)[:, :, :, pos],
                                   rtol=0, atol=1e-5)
    others = [i for i in range(L) if i != pos]
    assert torch.equal(tk[:, :, :, others], before[:, :, :, others])


def test_kv_decode_matches_full_forward_generate(models):
    _, tlm = models
    idx = np.random.default_rng(3).integers(0, 48, (3, 5)).astype(np.int64)
    np.testing.assert_array_equal(KVCacheDecoder(tlm).generate(idx.copy(), 10),
                                  tlm.generate(idx.copy(), 10))


def _jax_beam(jlm, idx, new, num_beams, eos_id=None):
    """The JAX package's prefill and ``_beam`` program at the port's
    positions (plen - 1)."""
    dec = JaxDecoder(jlm)
    B, plen = idx.shape
    params = dec._prep_jit(dec._gather())
    kc, vc, logits0 = dec._prefill_jit(params, jnp.asarray(_padded(idx)), plen)
    tokens, scores = dec._beam_jit(params, (kc, vc), logits0, np.int32(plen - 1), new,
                                   num_beams, eos_id, np.float32(1.0))
    seqs = np.concatenate(
        [np.broadcast_to(idx[:, None], (B, num_beams, plen)), np.asarray(tokens)], 2)
    return seqs, np.asarray(scores)


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("num_beams", [1, 3])
def test_generate_beam_matches_jax(models, num_beams, eos):
    jlm, tlm = models
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(num_beams).integers(0, 48, (2, 5)).astype(np.int64)
    eos_id = int(dec.generate(idx.copy(), 6)[0, 7]) if eos else None
    seqs, scores = dec.generate_beam(idx.copy(), 6, num_beams=num_beams, eos_id=eos_id,
                                     return_all=True)
    want_seqs, want_scores = _jax_beam(jlm, idx, 6, num_beams, eos_id)
    assert seqs.shape == (2, num_beams, 11)
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)
    if num_beams == 1 and not eos:  # one beam is greedy
        np.testing.assert_array_equal(seqs[:, 0], dec.generate(idx.copy(), 6))
    if eos:  # a beam that emitted eos pads with it
        assert (seqs[..., 5:] == eos_id).any()


@pytest.mark.parametrize("quant", ["int8", "w8a8"])
def test_quantised_bf16_beams_and_sampling(models, prompts, quant):
    """The quantised bf16 decoder's beams equal the dense f32 decoder's on
    the well-separated prompts; sampling with top_k=1 is greedy, a seed
    reproduces its draw and every token is in the vocabulary."""
    _, tlm = models
    dense = KVCacheDecoder(tlm)
    qdec = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant=quant)
    np.testing.assert_array_equal(qdec.generate_beam(prompts.copy(), 6, num_beams=2),
                                  dense.generate_beam(prompts.copy(), 6, num_beams=2))
    greedy = qdec.generate(prompts.copy(), 8)
    np.testing.assert_array_equal(
        qdec.generate(prompts.copy(), 8, temperature=1.3, top_k=1), greedy)
    a = qdec.generate(prompts.copy(), 8, temperature=0.8, top_k=10, top_p=0.9, seed=1)
    b = qdec.generate(prompts.copy(), 8, temperature=0.8, top_k=10, top_p=0.9, seed=1)
    np.testing.assert_array_equal(a, b)
    assert a[:, 6:].min() >= 0 and a[:, 6:].max() < 48


def test_streaming_matches_large_context_twin():
    """A window-4 model of max_len 16 generates 6 + 34 tokens on its ring
    cache (wrapping twice); the same weights at max_len 48 hold the whole
    stream without a ring.  The JAX package's own check: the tokens are
    equal, here to both packages' twins.  The stream's key holds its rope
    length (64); the decoder decodes normally again afterwards."""
    jbig, tbig = _pair(17, max_len=48)
    tsmall = LlamaLM(**CFG, device="cpu")
    load_jax_state_dict(tsmall, jbig.state_dict())
    prompt = np.random.default_rng(41).integers(0, 48, (2, 6)).astype(np.int64)
    dec = KVCacheDecoder(tsmall)
    got = dec.generate(prompt.copy(), 34)
    assert got.shape == (2, 40)
    np.testing.assert_array_equal(got, KVCacheDecoder(tbig).generate(prompt.copy(), 34))
    np.testing.assert_array_equal(got, JaxDecoder(jbig).generate(prompt.copy(), 34))
    assert [k[-1] for k in dec._loops if k[0] == "stream"] == [64]
    assert dec._rope_len == 0
    np.testing.assert_array_equal(dec.generate(prompt.copy(), 10), got[:, :16])


def test_streaming_rejected_without_window_or_past_max_prompt():
    _, tlm = _pair(13, window=None)
    prompt = np.random.default_rng(4).integers(0, 48, (1, 4)).astype(np.int64)
    with pytest.raises(ValueError, match="sliding-window"):
        KVCacheDecoder(tlm).generate(prompt, 30)
    _, wlm = _pair(13)
    with pytest.raises(ValueError, match="sliding-window"):
        KVCacheDecoder(wlm).generate(np.zeros((1, 17), np.int64), 3)  # prompt > max_len
