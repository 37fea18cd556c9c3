"""The port's KVCacheDecoder (deepflows_tpu_torch/models/decoding.py) against
the JAX package's, on the CPU, in every mode: quant None / "int8" / "w8a8"
by compute dtype f32 / bf16.  The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain twins.

Weights cross with ``load_jax_state_dict``; prompts are numpy arrays from a
seed.  Prefill logits: f32 within rtol and atol 1e-4; bf16 within the JAX
tests' bound, max |Δ| / max(1, |ref|) < 0.1 (tests/test_decoding.py).
Greedy tokens equal the JAX decoder's on the seed-13 model, on which the
JAX tests assert greedy equality across these modes.
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
from deepflows_tpu_torch.models import KVCacheDecoder, TransformerLM
from deepflows_tpu_torch.utils import load_jax_state_dict

CFG = dict(vocab_size=48, max_len=24, dim=32, depth=2, num_heads=2)
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


@pytest.fixture(scope="module")
def models13():
    df.manual_seed(13)
    jlm = jmodels.TransformerLM(**CFG, device="tpu", flash=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    return jlm, tlm


@pytest.fixture(scope="module")
def prompt13(models13):
    """Two prompts on whose f32 greedy path the seed-13 model's logits are
    well separated (top-1 minus top-2 >= 0.05 at every step), the
    condition under which the JAX tests expect every mode to decode the
    same tokens: bf16 and int8 move these logits by about 0.01."""
    jlm, _ = models13
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


def _tlm(seed):
    df.manual_seed(seed)
    jlm = jmodels.TransformerLM(**CFG, device="tpu", flash=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return tlm


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_logits_and_greedy_tokens_match_jax(models13, prompt13, quant, dtype):
    jlm, tlm = models13
    jdt, tdt = DTYPES[dtype]
    jdec = JaxDecoder(jlm, compute_dtype=jdt, quant=quant)
    tdec = KVCacheDecoder(tlm, compute_dtype=tdt, quant=quant)
    B, plen = prompt13.shape
    prompt = np.zeros((B, CFG["max_len"]), np.int32)
    prompt[:, :plen] = prompt13
    jk, jv, jlg = jdec._prefill_jit(
        jdec._prep_jit(jdec._gather()), jnp.asarray(prompt), plen
    )
    with torch.inference_mode():
        tk, tv, tlg = tdec._prefill(
            tdec._prep_tree(tdec._gather()), torch.as_tensor(prompt).long(), plen
        )
    assert tlg.dtype == torch.float32 and tlg.shape == (B, CFG["vocab_size"])
    assert tk.shape == tuple(jk.shape) == (2, B, 2, CFG["max_len"], 16)
    jlg = np.asarray(jlg)
    if dtype == "f32":
        np.testing.assert_allclose(tlg.numpy(), jlg, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
    else:
        assert tk.dtype == torch.bfloat16
        err = np.abs(tlg.numpy() - jlg) / np.maximum(1.0, np.abs(jlg))
        assert err.max() < 0.1, err.max()
    want = jdec.generate(prompt13.copy(), 8)
    got = tdec.generate(prompt13.copy(), 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant", QUANTS)
def test_prep_tree_fuses_qkv_then_quantises(models13, quant):
    _, tlm = models13
    dec = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant=quant)
    p = dec._prep_tree(dec._gather())
    blk = p["blocks"][0]
    assert "q_w" not in blk and blk["qkv_b"].shape == (1, 3 * CFG["dim"])
    assert p["tok"].dtype == torch.bfloat16 and blk["ln1_w"].dtype == torch.bfloat16
    if quant is None:
        assert blk["qkv_w"].shape == (CFG["dim"], 3 * CFG["dim"])
        assert blk["qkv_w"].dtype == torch.bfloat16
        return
    key = "w8a8" if quant == "w8a8" else "q"
    for w in (blk["qkv_w"], blk["o_w"], blk["fc1_w"], blk["fc2_w"], p["head_w"]):
        assert set(w) == {key, "s"}
        assert w[key].dtype == torch.int8 and w["s"].dtype == torch.float32
    assert blk["qkv_w"]["s"].shape == (3 * CFG["dim"],)


@pytest.mark.parametrize("quant", QUANTS)
def test_sampling_properties(quant):
    """top_k=1 and a tiny top_p are greedy; a seed reproduces its draw and
    another seed differs; every token stays inside the vocabulary."""
    dec = KVCacheDecoder(_tlm(7), quant=quant)
    idx = np.random.default_rng(5).integers(0, 48, (2, 5)).astype(np.int64)
    greedy = dec.generate(idx.copy(), 8)
    np.testing.assert_array_equal(
        dec.generate(idx.copy(), 8, temperature=1.7, top_k=1), greedy
    )
    np.testing.assert_array_equal(
        dec.generate(idx.copy(), 8, temperature=1.0, top_p=1e-6), greedy
    )
    a = dec.generate(idx.copy(), 8, temperature=1.0, seed=3)
    b = dec.generate(idx.copy(), 8, temperature=1.0, seed=3)
    c = dec.generate(idx.copy(), 8, temperature=1.0, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)  # 16 draws over 48 classes
    assert a[:, 5:].min() >= 0 and a[:, 5:].max() < 48
    d1 = dec.generate(idx.copy(), 8, temperature=0.8, top_k=10, top_p=0.9, seed=0)
    d2 = dec.generate(idx.copy(), 8, temperature=0.8, top_k=10, top_p=0.9, seed=0)
    np.testing.assert_array_equal(d1, d2)


@pytest.mark.parametrize("plen,new", [(1, 6), (5, 6), (12, 6), (4, 0), (4, 1)])
def test_kv_decode_matches_full_forward_generate(plen, new):
    tlm = _tlm(2)
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(plen).integers(0, 48, (2, plen)).astype(np.int64)
    got = dec.generate(idx.copy(), new)
    np.testing.assert_array_equal(got, tlm.generate(idx.copy(), new))
    assert got.shape == (2, plen + new) and got.dtype == idx.dtype


def test_rejects_overflow_and_bad_quant(models13):
    _, tlm = models13
    dec = KVCacheDecoder(tlm)
    with pytest.raises(ValueError):
        dec.generate(np.zeros((1, 20), np.int64), 10)  # 20 + 10 > max_len 24
    with pytest.raises(ValueError):
        dec.generate(np.zeros((1, 0), np.int64), 3)
    with pytest.raises(ValueError):
        KVCacheDecoder(tlm, quant="int4")


def test_device_none_raises_without_a_card_and_cpu_works():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**CFG)
    tlm = TransformerLM(**CFG, device="cpu")
    out = KVCacheDecoder(tlm, quant="int8").generate(np.ones((1, 3), np.int64), 4)
    assert out.shape == (1, 7)


@pytest.mark.parametrize("quant", QUANTS)
def test_beam_search_launches_no_kernel_on_the_cpu(models13, quant):
    """generate_beam on CPU tensors runs the kernels' plain twins: the
    ``_clean`` fixture finds every launch count still at 0."""
    _, tlm = models13
    dec = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant=quant)
    idx = np.random.default_rng(6).integers(0, 48, (2, 5)).astype(np.int64)
    seqs, scores = dec.generate_beam(idx.copy(), 4, num_beams=2, return_all=True)
    assert seqs.shape == (2, 2, 9) and np.isfinite(scores).all()
