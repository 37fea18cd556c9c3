"""The port's Hugging Face converters (``utils.hf_llama``, ``utils.hf_gpt2``)
against the JAX package's on the CPU, on random ``transformers`` Llama,
Mistral (sliding window), Mixtral and GPT-2 models at the JAX tests'
sizes (``tests/test_hf_llama.py``).

- The port's logits equal the JAX-converted model's within 1e-5 (f32,
  rtol and atol), and ``transformers``' forward within the JAX tests'
  tolerance (rtol 1e-3, atol 3e-4; 5e-4 for Mixtral, Mistral and GPT-2).
- The converted models decode greedily through the KV-cache decoder as
  their own full-forward ``generate`` and the JAX model's do.
- The same errors are raised: a missing key (``KeyError`` naming it), an
  array that does not fit or a key left over (``ValueError``), and
  ``attention_bias`` (``NotImplementedError``).
- The config is duck-typed and the state dict may hold numpy arrays (what
  ``chip_smoke.py`` feeds it) or bf16 tensors.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu.autograd import no_grad
from deepflows_tpu.utils import hf_gpt2 as jgpt2
from deepflows_tpu.utils import hf_llama as jllama
from deepflows_tpu_torch import models, ops
from deepflows_tpu_torch.utils import hf_gpt2, hf_llama

transformers = pytest.importorskip("transformers")

PORT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    ops.reset_launch_counts()
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)


def _ids(vocab, shape=(2, 10), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.tensor(ids)).logits.numpy()


def _jax_logits(model, ids):
    model.eval()
    with no_grad():
        return np.asarray(model(Tensor(ids, device="tpu")).data.array)


def _port_logits(model, ids):
    model.eval()
    with torch.no_grad():
        return model(torch.as_tensor(ids)).numpy()


def _check(hf, jm, tm, atol, seed=0):
    ids = _ids(hf.config.vocab_size, seed=seed)
    got = _port_logits(tm, ids)
    np.testing.assert_allclose(got, _jax_logits(jm, ids), rtol=PORT_TOL, atol=PORT_TOL)
    np.testing.assert_allclose(got, _hf_logits(hf, ids), rtol=1e-3, atol=atol)


def _llama(vocab=64, dim=32, layers=2, heads=4, kv_heads=2, inter=86, tie=False,
           theta=10000.0):
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=vocab, hidden_size=dim, intermediate_size=inter,
        num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=kv_heads,
        max_position_embeddings=16, rope_theta=theta, attention_bias=False,
        tie_word_embeddings=tie,
    )
    return transformers.LlamaForCausalLM(cfg).eval()


def _mixtral(layers=2):
    torch.manual_seed(1)
    cfg = transformers.MixtralConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=16,
        num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False,
    )
    return transformers.MixtralForCausalLM(cfg).eval()


def _mistral():
    torch.manual_seed(2)
    cfg = transformers.MistralConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=16,
        sliding_window=4, tie_word_embeddings=False,
    )
    hf = transformers.MistralForCausalLM(cfg).eval()
    hf._attn_implementation = "eager"  # sdpa may ignore sliding_window
    return hf


def _gpt2(layers=2, heads=4, seed=3):
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(vocab_size=64, n_positions=16, n_embd=32, n_layer=layers,
                                  n_head=heads)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.mark.parametrize("kw", [{}, dict(tie=True, heads=2, kv_heads=2, inter=64),
                                dict(heads=4, kv_heads=4, theta=500000.0)],
                         ids=["gqa", "tied", "mha_theta"])
def test_llama_logits(kw):
    hf = _llama(**kw)
    _check(hf, jllama.convert_hf_llama(hf, device="tpu"),
           hf_llama.convert_hf_llama(hf, device="cpu"), atol=3e-4)


def test_mistral_sliding_window_logits():
    hf = _mistral()
    tm = hf_llama.convert_hf_llama(hf, device="cpu")
    assert tm.blocks[0].attn.window == 4
    ids = _ids(64, (2, 12), seed=5)  # longer than the window: the band bites
    got = _port_logits(tm, ids)
    jm = jllama.convert_hf_llama(hf, device="tpu")
    np.testing.assert_allclose(got, _jax_logits(jm, ids), rtol=PORT_TOL, atol=PORT_TOL)
    np.testing.assert_allclose(got, _hf_logits(hf, ids), rtol=1e-3, atol=5e-4)


def test_mixtral_logits():
    hf = _mixtral()
    tm = hf_llama.convert_hf_mixtral(hf, device="cpu")
    _check(hf, jllama.convert_hf_mixtral(hf, device="tpu"), tm, atol=5e-4)
    assert all(not b.moe.router.bias.detach().any() for b in tm.blocks)


def test_gpt2_logits():
    hf = _gpt2()
    tm = hf_gpt2.convert_hf_gpt2(hf, device="cpu")
    assert tm.blocks[0].mlp[1].approximate == "tanh"
    _check(hf, jgpt2.convert_hf_gpt2(hf, device="tpu"), tm, atol=5e-4)
    assert not tm.head.bias.detach().any()


def test_converted_models_decode_like_their_forward():
    """The KV-cache decoder on converted weights gives the full-forward
    greedy tokens, which equal the JAX model's."""
    ids = _ids(64, (2, 4), seed=1).astype(np.int64)
    for hf, port_conv, jax_conv in ((_llama(), hf_llama.convert_hf_llama,
                                     jllama.convert_hf_llama),
                                    (_gpt2(layers=1, heads=2, seed=4), hf_gpt2.convert_hf_gpt2,
                                     jgpt2.convert_hf_gpt2)):
        tm = port_conv(hf, device="cpu")
        want = tm.generate(ids, 5)
        np.testing.assert_array_equal(models.KVCacheDecoder(tm).generate(ids, 5), want)
        np.testing.assert_array_equal(jax_conv(hf, device="tpu").generate(ids, 5), want)


def test_numpy_state_dict_and_duck_typed_config():
    """A ``SimpleNamespace`` with ``config.json``'s names and a state dict of
    numpy arrays (what a user without ``transformers`` holds) give the same
    model as the one-call conversion."""
    hf = _mistral()
    c = hf.config
    ns = SimpleNamespace(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size, num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads, num_key_value_heads=c.num_key_value_heads,
        max_position_embeddings=c.max_position_embeddings, rms_norm_eps=c.rms_norm_eps,
        rope_theta=c.rope_theta, sliding_window=c.sliding_window,
    )
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    tm = hf_llama.build_llama_from_hf_config(ns, max_len=12, device="cpu")
    hf_llama.load_hf_llama_state(tm, sd)
    ref = hf_llama.convert_hf_llama(hf, device="cpu")
    assert tm.max_len == 12 and tm.blocks[0].attn.window == 4
    for (n, a), (_, b) in zip(tm.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), n
    gm = _gpt2()
    g = gm.config
    gns = SimpleNamespace(vocab_size=g.vocab_size, n_positions=g.n_positions, n_embd=g.n_embd,
                          n_layer=g.n_layer, n_head=g.n_head,
                          layer_norm_epsilon=g.layer_norm_epsilon)
    tg = hf_gpt2.build_gpt2_from_hf_config(gns, device="cpu")
    hf_gpt2.load_hf_gpt2_state(tg, {k: v.numpy() for k, v in gm.state_dict().items()})
    ids = _ids(64)
    np.testing.assert_array_equal(_port_logits(tg, ids),
                                  _port_logits(hf_gpt2.convert_hf_gpt2(gm, device="cpu"), ids))


def test_bf16_state_dict_loads_widened():
    """bf16 tensors (the dtype real checkpoints ship in) load as their f32
    values; the JAX converter goes through numpy, which has no bf16."""
    hf = _llama()
    sd = {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()}
    tm = hf_llama.build_llama_from_hf_config(hf.config, device="cpu")
    hf_llama.load_hf_llama_state(tm, sd)
    assert torch.equal(tm.blocks[1].attn.q_proj.weight,
                       sd["model.layers.1.self_attn.q_proj.weight"].float().t())


def _raises_alike(exc, match, jax_fn, port_fn):
    with pytest.raises(exc, match=match):
        jax_fn()
    with pytest.raises(exc, match=match):
        port_fn()


def test_llama_errors_match_jax():
    hf = _llama()
    sd = hf.state_dict()
    jm = jllama.build_llama_from_hf_config(hf.config, device="tpu")
    tm = hf_llama.build_llama_from_hf_config(hf.config, device="cpu")
    cases = []
    bad = dict(sd)
    bad.pop("model.norm.weight")
    cases.append((KeyError, "model.norm.weight", bad))
    bad = dict(sd)
    bad["model.embed_tokens.weight"] = torch.zeros(8, 8)
    cases.append((ValueError, "model.embed_tokens.weight: shape .* does not fit", bad))
    bad = dict(sd)
    bad["model.layers.0.self_attn.q_proj.weight"] = torch.zeros(32, 31)
    cases.append((ValueError, "q_proj.weight: shape .* does not fit", bad))
    bad = dict(sd, **{"model.layers.9.mlp.extra.weight": torch.zeros(2)})
    cases.append((ValueError, "unconverted state_dict entries", bad))
    for exc, match, bad in cases:
        _raises_alike(exc, match, lambda: jllama.load_hf_llama_state(jm, bad),
                      lambda: hf_llama.load_hf_llama_state(tm, bad))
    # a leftover rotary buffer is not a weight
    hf_llama.load_hf_llama_state(tm, dict(sd, **{"model.rotary_emb.inv_freq": torch.zeros(4)}))
    cfg = transformers.LlamaConfig(attention_bias=True)
    _raises_alike(NotImplementedError, "attention_bias",
                  lambda: jllama.build_llama_from_hf_config(cfg),
                  lambda: hf_llama.build_llama_from_hf_config(cfg, device="cpu"))


def test_mixtral_errors_match_jax():
    hf = _mixtral(layers=1)
    sd = dict(hf.state_dict())
    jm = jllama.build_mixtral_from_hf_config(hf.config, device="tpu")
    tm = hf_llama.build_mixtral_from_hf_config(hf.config, device="cpu")
    bad = dict(sd)
    bad.pop("model.layers.0.block_sparse_moe.experts.2.w1.weight")
    _raises_alike(KeyError, "experts.2.w1", lambda: jllama.load_hf_mixtral_state(jm, bad),
                  lambda: hf_llama.load_hf_mixtral_state(tm, bad))
    bad = dict(sd)
    bad["model.layers.0.block_sparse_moe.experts.1.w3.weight"] = torch.zeros(64, 31)
    with pytest.raises(ValueError):  # numpy's stack refuses it in JAX
        jllama.load_hf_mixtral_state(jm, bad)
    with pytest.raises(ValueError, match="experts.1.w3.weight: shape"):
        hf_llama.load_hf_mixtral_state(tm, bad)
    bad = dict(sd)
    bad["model.layers.0.block_sparse_moe.gate.weight"] = torch.zeros(5, 32)
    _raises_alike(ValueError, "gate.weight: shape .* does not fit",
                  lambda: jllama.load_hf_mixtral_state(jm, bad),
                  lambda: hf_llama.load_hf_mixtral_state(tm, bad))


def test_gpt2_errors_match_jax():
    hf = _gpt2(layers=1, heads=2, seed=4)
    sd = dict(hf.state_dict())
    jm = jgpt2.build_gpt2_from_hf_config(hf.config, device="tpu")
    tm = hf_gpt2.build_gpt2_from_hf_config(hf.config, device="cpu")
    bad = dict(sd)
    bad.pop("transformer.ln_f.bias")
    _raises_alike(KeyError, "ln_f.bias", lambda: jgpt2.load_hf_gpt2_state(jm, bad),
                  lambda: hf_gpt2.load_hf_gpt2_state(tm, bad))
    bad = dict(sd, **{"transformer.h.0.attn.c_attn.weight": torch.zeros(32, 64)})
    _raises_alike(ValueError, "c_attn.weight", lambda: jgpt2.load_hf_gpt2_state(jm, bad),
                  lambda: hf_gpt2.load_hf_gpt2_state(tm, bad))
    bad = dict(sd, **{"transformer.wpe.weight": torch.zeros(8, 32)})
    _raises_alike(ValueError, "wpe covers 8 positions", lambda: jgpt2.load_hf_gpt2_state(jm, bad),
                  lambda: hf_gpt2.load_hf_gpt2_state(tm, bad))
    bad = dict(sd, **{"transformer.h.0.extra": torch.zeros(2)})
    _raises_alike(ValueError, "unconverted", lambda: jgpt2.load_hf_gpt2_state(jm, bad),
                  lambda: hf_gpt2.load_hf_gpt2_state(tm, bad))
    # the causal-mask buffers are not weights
    hf_gpt2.load_hf_gpt2_state(tm, dict(sd, **{"transformer.h.0.attn.bias": torch.ones(2),
                                               "transformer.h.0.attn.masked_bias": torch.ones(1)}))


def test_decoder_runs_the_exact_gelu_as_jax_does():
    """A limit of the reference, kept by the port: the KV-cache decoder's
    MLP is the exact-erf GELU whatever the block's (the JAX decoder's
    ``jax.nn.gelu(approximate=False)``), so a converted GPT-2 (tanh GELU)
    prefills with the model's forward of exact GELUs, not its own.  The c_fc
    weights are scaled so that the two GELUs part measurably."""
    from deepflows_tpu_torch import nn

    hf = _gpt2()
    with torch.no_grad():
        for b in hf.transformer.h:
            b.mlp.c_fc.weight.mul_(50.0)
    tm = hf_gpt2.convert_hf_gpt2(hf, device="cpu").eval()
    ids = _ids(64, (2, 10), seed=2)
    prompt = torch.zeros((2, tm.max_len), dtype=torch.long)
    prompt[:, :10] = torch.as_tensor(ids)
    dec = models.KVCacheDecoder(tm)
    with torch.no_grad():
        got = dec._prefill(dec._prepared(), prompt, 10)[2]
        tanh = tm(torch.as_tensor(ids))[:, -1]
        for b in tm.blocks:
            b.mlp[1] = nn.GELU()
        exact = tm(torch.as_tensor(ids))[:, -1]
    assert float((got - exact).abs().max()) < 1e-6
    assert float((got - tanh).abs().max()) > 1e-5  # the gap the decoder leaves
