"""The port's TransformerLM and its modules (deepflows_tpu_torch) against the
JAX package on the CPU.

Each test builds the module in both packages, copies the JAX weights across
with ``load_jax_state_dict`` and feeds both the same numpy inputs from a
seed.  f32 outputs agree to rtol and atol 1e-4 (the same ops, summed in
another order).
"""

import math

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch.models import EncoderBlock, TransformerLM
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(17)
CFG = dict(vocab_size=48, max_len=24, dim=32, depth=2, num_heads=2)


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
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)


def _jax_lm(seed=5):
    df.manual_seed(seed)
    return jmodels.TransformerLM(**CFG, device="tpu", flash=False)


def _pair(seed=5):
    jlm = _jax_lm(seed)
    tlm = TransformerLM(**CFG, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    return jlm, tlm


def _jax_out(module, x):
    with df.no_grad():
        return module(Tensor(x, device="tpu")).numpy()


def test_state_dict_keys_and_shapes_match_jax():
    jsd = _jax_lm().state_dict()
    tsd = TransformerLM(**CFG, device="cpu").state_dict()
    assert list(tsd) == list(jsd)
    for k, v in jsd.items():
        assert tuple(tsd[k].shape) == v.shape, k
        assert tsd[k].dtype == torch.float32


def test_forward_logits_match_jax():
    jlm, tlm = _pair()
    idx = RNG.integers(0, CFG["vocab_size"], (3, CFG["max_len"])).astype(np.int64)
    want = _jax_out(jlm, idx)
    with torch.no_grad():
        got = tlm(torch.from_numpy(idx)).numpy()
    assert got.shape == (3, CFG["max_len"], CFG["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_forward_rejects_overlong_sequence():
    tlm = TransformerLM(**CFG, device="cpu")
    with pytest.raises(ValueError):
        tlm(torch.zeros((1, CFG["max_len"] + 1), dtype=torch.long))


@pytest.mark.parametrize("plen,new", [(6, 10), (1, 5), (20, 4)])
def test_greedy_generate_matches_jax(plen, new):
    jlm, tlm = _pair(seed=9)
    idx = RNG.integers(0, CFG["vocab_size"], (2, plen)).astype(np.int64)
    want = jlm.generate(idx.copy(), new)
    got = tlm.generate(idx.copy(), new)
    np.testing.assert_array_equal(got, want)
    assert tlm.training  # generate restores the mode it found


def test_linear_init_bound_follows_jax_fan_convention():
    # (in, out) weight: fan_in = shape[1] = out_features, so the
    # kaiming-uniform(a=√5) bound is 1/√out_features; the bias bound is
    # 1/√in_features
    lin = tnn.Linear(16, 400, device="cpu")
    jlin = jnn.Linear(16, 400, device="tpu")
    bound = 1.0 / math.sqrt(400)
    w = lin.weight.detach().abs().max().item()
    jw = float(np.abs(jlin.weight.numpy()).max())
    assert 0.95 * bound < w <= bound
    assert 0.95 * bound < jw <= bound
    assert lin.bias.detach().abs().max().item() <= 1.0 / math.sqrt(16)
    assert lin.weight.shape == (16, 400) and lin.bias.shape == (1, 400)


def test_init_draws_from_the_package_generator():
    import deepflows_tpu_torch as dt

    dt.manual_seed(3)
    a = TransformerLM(**CFG, device="cpu").state_dict()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(123)  # torch's global generator plays no part
        dt.manual_seed(3)
        b = TransformerLM(**CFG, device="cpu").state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_matches_jax(causal):
    df.manual_seed(2)
    jm = jnn.MultiheadAttention(32, 4, causal=causal, device="tpu", flash=False)
    tm = tnn.MultiheadAttention(32, 4, causal=causal, device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    q = RNG.standard_normal((2, 7, 32)).astype(np.float32)
    kv = RNG.standard_normal((2, 7, 32)).astype(np.float32)
    with df.no_grad():
        jo, jw = jm(Tensor(q, device="tpu"), Tensor(kv, device="tpu"),
                    need_weights=True)
    with torch.no_grad():
        to, tw = tm(torch.from_numpy(q), torch.from_numpy(kv), need_weights=True)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), jw.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "kw",
    [dict(num_kv_heads=1), dict(ring=("mesh", "seq")), dict(num_kv_heads=2),
     dict(rope=True), dict(causal=True, window=4)],
)
def test_multihead_attention_later_slices_raise(kw):
    """The later slices' options build and run: ring attention (the parallel
    slice; tests/test_torch_ring_attention.py runs its route on 4 ranks)
    takes self-attention, and a call with key and value given takes the
    plain route here; GQA, RoPE and the window (the Llama slice;
    tests/test_torch_llama.py holds them against the JAX package)."""
    m = tnn.MultiheadAttention(32, 4, device="cpu", **kw)
    x = torch.from_numpy(RNG.standard_normal((2, 6, 32)).astype(np.float32))
    if "ring" in kw:
        assert m.ring == kw["ring"] and m._use_ring(False, True)
        with torch.no_grad():
            out = m(x, x, x)
        assert out.shape == (2, 6, 32) and torch.isfinite(out).all()
        return
    with torch.no_grad():
        out = m(x)
    assert out.shape == (2, 6, 32) and torch.isfinite(out).all()


def test_encoder_block_and_layers_match_jax():
    df.manual_seed(4)
    jb = jmodels.vit.EncoderBlock(32, 2, causal=True, device="tpu", flash=False)
    tb = EncoderBlock(32, 2, causal=True, device="cpu")
    load_jax_state_dict(tb, jb.state_dict())
    x = RNG.standard_normal((2, 5, 32)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            tb(torch.from_numpy(x)).numpy(), _jax_out(jb, x), rtol=1e-4, atol=1e-4
        )
        for jmod, tmod in ((jnn.LayerNorm(32, device="tpu"), tnn.LayerNorm(32, device="cpu")),
                           (jnn.GELU(), tnn.GELU())):
            np.testing.assert_allclose(
                tmod(torch.from_numpy(x)).numpy(), _jax_out(jmod, x),
                rtol=1e-5, atol=1e-6,
            )


def test_load_jax_state_dict_is_strict():
    jsd = dict(_jax_lm().state_dict())
    tlm = TransformerLM(**CFG, device="cpu")
    extra = dict(jsd, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        load_jax_state_dict(tlm, extra)
    missing = {k: v for k, v in jsd.items() if k != "pos_embed"}
    with pytest.raises(KeyError):
        load_jax_state_dict(tlm, missing)
    with pytest.raises(ValueError):
        load_jax_state_dict(tlm, dict(jsd, pos_embed=jsd["pos_embed"][:, :3]))
    with pytest.raises(TypeError):
        load_jax_state_dict(tlm, dict(jsd, pos_embed=jsd["pos_embed"].astype(np.float64)))


def test_device_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**CFG)
    with pytest.raises(RuntimeError):
        tnn.Linear(4, 4)
    assert TransformerLM(**CFG, device="cpu").tok_embed.weight.device.type == "cpu"
