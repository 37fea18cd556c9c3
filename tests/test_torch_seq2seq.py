"""The port's encoder-decoder family (``models.Seq2SeqTransformer``,
``CrossDecoderBlock``, ``Seq2SeqGenerator``) against the JAX package's on the
CPU, mirroring ``tests/test_seq2seq.py``.

Models: vocab 24, src_len and tgt_len 8, dim 32, 2 heads, depth 2 + 2,
built by the JAX package and carried across with ``load_jax_state_dict``
(the learned positions set away from their zero init, so they act).
Tolerances: f32 logits and every parameter's gradient within 1e-5; a
3-step ``CompiledTrainStep`` Adam trajectory's losses within 1e-5; greedy
tokens equal in f32; bf16 tokens equal on sources whose f32 top-2 logit
margin is at least 0.05 at every step (the comparison rule of ROADMAP.md
queue 3: bf16 intermediates round at other places in XLA and torch).
"""

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu.models.seq2seq import Seq2SeqGenerator as JaxGenerator
from deepflows_tpu_torch import models, nn, ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.utils import load_jax_state_dict

CFG = dict(vocab_size=24, src_len=8, tgt_len=8, dim=32, enc_depth=2, dec_depth=2,
           num_heads=2)
RNG = np.random.default_rng(29)
TOL = 1e-5
MARGIN = 0.05


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


def _pair(seed=3, device="cpu", **kw):
    """The same model in both packages: JAX's weights, its positions drawn
    away from zero and its head scaled up (wider logit margins), carried
    into the port."""
    df.manual_seed(seed)
    cfg = dict(CFG, **kw)
    jm = jmodels.Seq2SeqTransformer(**cfg, device=device)
    r = np.random.default_rng(seed)
    sd = dict(jm.state_dict())
    for k in ("src_pos", "tgt_pos"):
        sd[k] = (r.standard_normal(sd[k].shape) * 0.5).astype(np.float32)
    sd["head.weight"] = sd["head.weight"] * np.float32(20.0)
    jm.load_state_dict(sd)
    tm = models.Seq2SeqTransformer(**cfg, device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


def _batch(n=3, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, CFG["vocab_size"], (n, CFG["src_len"])),
            r.integers(0, CFG["vocab_size"], (n, CFG["tgt_len"])))


def _tape_greedy(model, src, n, bos=0):
    """Greedy decoding through the port's forward: teacher-force the grown
    prefix each step and take the argmax at the last position read; also
    the top-2 margin of each step's logits."""
    B = src.shape[0]
    out = np.zeros((B, 0), np.int64)
    margins = []
    with torch.no_grad():
        for t in range(n):
            tgt_in = np.zeros((B, model.tgt_len), np.int64)
            tgt_in[:, 0] = bos
            tgt_in[:, 1:t + 1] = out
            logits = model(torch.as_tensor(np.concatenate([src, tgt_in], 1)))[:, t]
            top2 = torch.topk(logits, 2).values
            margins.append((top2[:, 0] - top2[:, 1]).numpy())
            out = np.concatenate([out, logits.argmax(-1).numpy()[:, None]], 1)
    return out, np.stack(margins, 1)


def test_structure_and_state_dict_match_jax():
    jm, tm = _pair()
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]
    assert isinstance(tm.enc_blocks, nn.ModuleList) and isinstance(tm.src_pos, nn.Parameter)
    assert isinstance(tm.dec_blocks[0], models.CrossDecoderBlock)
    attn = [m for m in tm.modules() if isinstance(m, nn.MultiheadAttention)]
    assert len(attn) == 6 and all(a.flash is False for a in attn)
    assert [a.causal for a in attn] == [False, False, True, False, True, False]
    t0 = models.Seq2SeqTransformer(**CFG, device="cpu")
    assert torch.equal(t0.src_pos, torch.zeros(1, 8, 32)) and t0.src_pos.requires_grad


def test_forward_logits_and_gradients_match_jax():
    """f32 logits, the CE loss and every parameter's gradient within 1e-5
    of the JAX tape's."""
    jm, tm = _pair()
    src, tgt = _batch()
    x = np.concatenate([src, tgt], 1)
    y = _batch(seed=1)[1]
    jl = jm(Tensor(x, device="cpu"))
    tl = tm(torch.as_tensor(x))
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), rtol=TOL, atol=TOL)
    jloss = jnn.CrossEntropyLoss()(jl, Tensor(y, device="cpu"))
    tloss = nn.CrossEntropyLoss()(tl, torch.as_tensor(y))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()), rtol=TOL)
    jloss.backward()
    tloss.backward()
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        scale = max(1.0, float(np.abs(jg[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), jg[n], rtol=TOL, atol=TOL * scale,
                                   err_msg=n)


@pytest.mark.parametrize("fused", [False, True])
def test_three_step_adam_trajectory_matches_jax(fused):
    """CompiledTrainStep(model, Adam, CrossEntropyLoss()) on the reversal
    task of tests/test_seq2seq.py: three losses within 1e-5 of the JAX
    step's, and the weights after them within 1e-4 (but the key biases:
    softmax is blind to them, so their gradient is rounding noise, which
    Adam's normalised step turns into moves of about lr either way)."""
    jm, tm = _pair(device="tpu")
    jstep = JaxStep(jm, joptim.Adam(jm.parameters(), lr=3e-3), jnn.CrossEntropyLoss())
    tstep = CompiledTrainStep(tm, optim.Adam(tm.parameters(), lr=3e-3, fused=fused),
                              nn.CrossEntropyLoss())
    r = np.random.default_rng(7)
    for i in range(3):
        src = r.integers(1, CFG["vocab_size"], (4, CFG["src_len"]))
        tgt = src[:, ::-1].copy()
        tgt_in = np.concatenate([np.zeros((4, 1), np.int64), tgt[:, :-1]], 1)
        x = np.concatenate([src, tgt_in], 1)
        want, got = float(jstep(x, tgt)), float(tstep(x, tgt))
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (i, got, want)
    for n, p in tm.state_dict().items():
        if n.endswith("k_proj.bias"):
            continue  # its gradient is 0 but for rounding, which Adam scales up to lr
        np.testing.assert_allclose(p.numpy(), jm.state_dict()[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("bos", [0, 3])
def test_greedy_tokens_match_jax_and_the_tape(bos):
    """f32 greedy tokens equal JAX's generate and the port's own tape
    greedy; ``model.generate`` keeps one generator."""
    jm, tm = _pair(seed=11)
    src = _batch(4, seed=2)[0]
    want = jm.generate(src, 6, bos_id=bos)
    got = tm.generate(src, 6, bos_id=bos)
    assert got.shape == (4, 6) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _tape_greedy(tm, src, 6, bos)[0])
    gen = tm._generator
    tm.generate(src[:2], 8, bos_id=bos)
    assert tm._generator is gen
    assert set(gen._loops) == {("decode", 4, 8, 6, torch.float32),
                               ("decode", 2, 8, 8, torch.float32)}


def test_short_source_and_full_target():
    """A source shorter than src_len and the whole tgt_len generated."""
    jm, tm = _pair(seed=4)
    src = _batch(3, seed=5)[0][:, :5]
    np.testing.assert_array_equal(tm.generate(src, 8), jm.generate(src, 8))
    np.testing.assert_array_equal(tm.generate(torch.as_tensor(src), 8), jm.generate(src, 8))


def test_bf16_tokens_match_jax_where_margins_allow():
    """bf16 generators of both packages on the sources whose f32 greedy
    path has a top-2 margin of at least 0.05 at every step: equal tokens,
    and equal to the f32 ones there."""
    import jax.numpy as jnp

    jm, tm = _pair(seed=13)
    src = _batch(16, seed=6)[0]
    f32, margins = _tape_greedy(tm, src, 6)
    keep = (margins >= MARGIN).all(1)
    assert keep.sum() >= 4, margins.min(1)
    src = src[keep]
    want = JaxGenerator(jm, compute_dtype=jnp.bfloat16).generate(src, 6)
    gen = models.Seq2SeqGenerator(tm, compute_dtype=torch.bfloat16)
    got = gen.generate(src, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, f32[keep])
    assert gen._params["dec"][0]["s_q_w"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())  # cast copies only


def test_generator_reads_live_weights():
    """A weight changed in place between two generate() calls is read: the
    tokens move, and equal a fresh generator's."""
    _, tm = _pair(seed=17)
    src = _batch(3, seed=8)[0]
    gen = models.Seq2SeqGenerator(tm)
    before = gen.generate(src, 5)
    tok = int(np.setdiff1d(np.arange(CFG["vocab_size"]), before)[0])
    with torch.no_grad():
        tm.head.bias[0, tok] += 100.0
    after = gen.generate(src, 5)
    assert (after == tok).all()
    np.testing.assert_array_equal(after, models.Seq2SeqGenerator(tm).generate(src, 5))


def test_validation_errors_match_jax():
    jm, tm = _pair()
    src, tgt = _batch(2)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="new_tokens"):
            m.generate(src, 9)  # > tgt_len
        with pytest.raises(ValueError, match="new_tokens"):
            m.generate(src, 0)
        with pytest.raises(ValueError, match="src must be"):
            m.generate(src[0], 4)  # not 2-D
    with pytest.raises(ValueError, match="source length 9 > src_len 8"):
        tm.generate(np.zeros((1, 9), np.int64), 2)
    long_src = torch.zeros((1, 9), dtype=torch.long)
    with pytest.raises(ValueError, match="source length 9 > src_len 8"):
        tm.encode(long_src)
    with pytest.raises(ValueError, match="source length 9 > src_len 8"):
        jm.encode(Tensor(long_src.numpy(), device="cpu"))
    mem = tm.encode(torch.as_tensor(src))
    with pytest.raises(ValueError, match="target length 9 > tgt_len 8"):
        tm.decode(torch.zeros((2, 9), dtype=torch.long), mem)


def test_generator_refuses_an_unmerged_lora_model():
    _, tm = _pair()
    nn.apply_lora(tm, r=2, target=["q_proj"])
    with pytest.raises(RuntimeError, match="Seq2SeqGenerator"):
        models.Seq2SeqGenerator(tm)
    nn.merge_lora(tm)
    assert models.Seq2SeqGenerator(tm).generate(_batch(1)[0], 2).shape == (1, 2)


def test_dropout_blocks_and_train_mode():
    """With dropout the blocks hold Dropout modules and train-mode outputs
    vary; eval mode equals the JAX model's."""
    jm, tm = _pair(dropout=0.1)
    assert tm.dec_blocks[0].drop is not None and tm.enc_blocks[0].drop is not None
    x = np.concatenate(_batch(2), 1)
    tm.train()
    a, b = tm(torch.as_tensor(x)), tm(torch.as_tensor(x))
    assert not torch.equal(a, b)
    tm.eval()
    jm.eval()
    np.testing.assert_allclose(tm(torch.as_tensor(x)).detach().numpy(),
                               jm(Tensor(x, device="cpu")).numpy(), rtol=TOL, atol=TOL)
