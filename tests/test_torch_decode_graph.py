"""The port's capturable decode step (deepflows_tpu_torch/models/decoding.py)
against the JAX package's, on the CPU, where the step that a CUDA graph
replays on the card runs eagerly.

- ``_forward_one`` with its position as a 0-d int64 tensor against the JAX
  step at positions 0, 5 and max_len - 1: logits and the cache rows it
  writes, f32, within 1e-5 (the same f32 products summed in other orders;
  logits are about 1).
- The tensors a graph reads stay valid across generate() calls: a weight
  changed between two calls (in place, or a new tensor bound to the
  parameter) is read, as a fresh decoder reads it; and two calls of one
  sampling key with other temperature, top_p and seed give what fresh
  decoders give.

Weights cross with ``load_jax_state_dict``; prompts are numpy arrays from a
seed.  The JAX side runs its Pallas kernels in interpret mode, the port its
kernels' plain twins.
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
QUANTS = [None, "int8", "w8a8"]


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
    Graph.free_graph_all()
    return jlm, tlm


def _tlm(seed):
    df.manual_seed(seed)
    jlm = jmodels.TransformerLM(**CFG, device="tpu", flash=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return tlm


@pytest.mark.parametrize("pos", [0, 5, CFG["max_len"] - 1])
def test_device_pos_step_matches_jax_forward_one(models13, pos):
    jlm, tlm = models13
    jdec, tdec = JaxDecoder(jlm), KVCacheDecoder(tlm)
    rng = np.random.default_rng(pos)
    L, plen = CFG["max_len"], 4
    prompt = np.zeros((3, L), np.int32)
    prompt[:, :plen] = rng.integers(0, 48, (3, plen))
    tok = rng.integers(0, 48, (3,))
    jparams = jdec._prep_jit(jdec._gather())
    jk, jv, _ = jdec._prefill_jit(jparams, jnp.asarray(prompt), plen)
    jlg, jk, jv = jdec._forward_one(
        jparams, jk, jv, jnp.asarray(tok, jnp.int32), pos, jnp.arange(L)
    )
    with torch.inference_mode():
        params = tdec._prep_tree(tdec._gather())
        tk, tv, _ = tdec._prefill(params, torch.as_tensor(prompt).long(), plen)
        before = tk.clone()
        at = torch.tensor(pos)
        tlg, tk2, tv2 = tdec._forward_one(
            params, tk, tv, torch.as_tensor(tok), at, torch.arange(L)
        )
    assert at.dim() == 0 and tk2 is tk and tv2 is tv  # the caches are written in place
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=1e-5)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(
            got[:, :, :, pos].numpy(), np.asarray(want)[:, :, :, pos], rtol=0, atol=1e-5
        )
    others = [i for i in range(L) if i != pos]
    assert torch.equal(tk[:, :, :, others], before[:, :, :, others])


@pytest.mark.parametrize("how", ["in_place", "new_tensor"])
@pytest.mark.parametrize("quant", QUANTS)
def test_generate_reads_a_weight_changed_between_calls(quant, how):
    tlm = _tlm(4)
    dec = KVCacheDecoder(tlm, quant=quant)
    idx = np.random.default_rng(9).integers(0, 48, (2, 5)).astype(np.int64)
    first = dec.generate(idx.copy(), 8)
    w = tlm.blocks[0].mlp[2].weight
    with torch.no_grad():
        if how == "in_place":
            w.mul_(-4.0)
        else:
            w.data = w.data * -4.0
    again = dec.generate(idx.copy(), 8)
    np.testing.assert_array_equal(again, KVCacheDecoder(tlm, quant=quant).generate(idx.copy(), 8))
    assert not np.array_equal(again, first)  # the change moves the tokens
    assert len(dec._loops) == 1  # one key served both calls


def test_one_sampling_key_serves_other_temperature_top_p_and_seed():
    tlm = _tlm(7)
    dec = KVCacheDecoder(tlm)
    idx = np.random.default_rng(5).integers(0, 48, (2, 5)).astype(np.int64)
    calls = [dict(temperature=0.7, top_k=10, top_p=0.8, seed=3),
             dict(temperature=1.3, top_k=10, top_p=0.95, seed=5),
             dict(temperature=0.7, top_k=10, top_p=0.8, seed=3)]
    outs = [dec.generate(idx.copy(), 10, **kw) for kw in calls]
    assert len(dec._loops) == 1
    for kw, out in zip(calls, outs):
        np.testing.assert_array_equal(out, KVCacheDecoder(tlm).generate(idx.copy(), 10, **kw))
    np.testing.assert_array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], outs[1])


def test_loop_keys_follow_the_static_arguments():
    """A key per (rows, do_sample, top_k, top_p set), as the JAX decoder
    compiles per static argument; the length of a request is no part of it."""
    tlm = _tlm(2)
    dec = KVCacheDecoder(tlm)
    rng = np.random.default_rng(0)
    two, one = rng.integers(0, 48, (2, 4)), rng.integers(0, 48, (1, 4))
    dec.generate(two, 3)
    dec.generate(two, 9)
    dec.generate(one, 5)
    dec.generate(two, 5, temperature=0.9, seed=1)
    dec.generate(two, 5, temperature=0.9, top_k=5, seed=1)
    dec.generate(two, 5, temperature=0.5, top_k=5, top_p=0.9, seed=2)
    dec.generate(two, 6, temperature=0.8, top_k=5, top_p=0.5, seed=2)
    got = {(k[1][1], k[3], k[4], k[5]) for k in dec._loops if k[0] == "decode"}
    assert got == {(1, False, None, False), (2, False, None, False), (2, True, None, False),
                   (2, True, 5, False), (2, True, 5, True)}
    assert len(dec._loops) == len(got)
