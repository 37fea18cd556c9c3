"""The port's Mixtral family (deepflows_tpu_torch: ``nn.MoE`` in its four
gating modes with its aux and z losses, ``nn.MoECriterion``,
``models.MixtralLM`` and ``MixtralKVCacheDecoder``) and
``load_jax_state_dict`` on a bf16 MixtralLM, against the JAX package on the
CPU.

Weights cross with ``load_jax_state_dict``; inputs are numpy arrays from a
seed.  Tolerances: f32 rtol and atol 1e-4 (tests/test_torch_decoding.py);
bf16 prefill logits max |Δ| / max(1, |ref|) < 0.1 (tests/test_decoding.py);
tokens equal on prompts whose f32 greedy path keeps a top-1 minus top-2
logit margin of at least 0.05.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.models import KVCacheDecoder, MixtralKVCacheDecoder, MixtralLM
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(43)
CFG = dict(vocab_size=48, max_len=16, dim=32, depth=2, num_heads=4, num_kv_heads=2,
           n_experts=4, top_k=2)
TOL = dict(rtol=1e-4, atol=1e-4)


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
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


GATING = {  # MoE(8, 16, 4, ...) options: the four gating modes
    "dense_gelu": dict(),
    "top2_relu": dict(top_k=2, activation="relu"),
    "capacity": dict(capacity_factor=1.0),
    "swiglu_top2": dict(top_k=2, swiglu=True),
}


@pytest.mark.parametrize("case", list(GATING))
def test_moe_matches_jax(case):
    """Output, aux and z losses, expert and dropped fractions, and the
    gradients of x and of every parameter through output + aux + z."""
    df.manual_seed(7)
    jm = jnn.MoE(8, 16, 4, device="tpu", **GATING[case])
    tm = tnn.MoE(8, 16, 4, device="cpu", **GATING[case])
    sd = jm.state_dict()
    if "experts_b1" in sd:  # non-zero biases, so their gradients show
        sd = dict(sd, experts_b1=RNG.standard_normal(sd["experts_b1"].shape).astype(np.float32),
                  experts_b2=RNG.standard_normal(sd["experts_b2"].shape).astype(np.float32))
        jm.load_state_dict(sd)
    load_jax_state_dict(tm, sd)
    x = RNG.standard_normal((2, 6, 8)).astype(np.float32) * 2
    xj = Tensor(x, device="tpu", requires_grad=True)
    jout = jm(xj)
    ((jout * jout).sum() + jm.last_aux_loss + jm.last_z_loss).backward()
    xt = torch.from_numpy(x).requires_grad_()
    tout = tm(xt)
    ((tout * tout).sum() + tm.last_aux_loss + tm.last_z_loss).backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    for name in ("last_aux_loss", "last_z_loss", "last_expert_fraction"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   getattr(jm, name).numpy(), **TOL, err_msg=name)
    if case == "capacity":
        dropped = float(tm.last_dropped_fraction)
        assert dropped > 0  # 12 tokens, capacity 3 an expert: some dropped
        np.testing.assert_allclose(dropped, float(jm.last_dropped_fraction.numpy()), **TOL)
    else:
        assert tm.last_dropped_fraction is None is jm.last_dropped_fraction
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), **TOL)
    tparams = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(tparams[name].grad.numpy(), p.grad.numpy(), **TOL,
                                   err_msg=f"grad of {name}")


def _pair(seed=5, **kw):
    df.manual_seed(seed)
    cfg = dict(CFG, **kw)
    jlm = jmodels.MixtralLM(**cfg, device="tpu", flash=False)
    tlm = MixtralLM(**cfg, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    Graph.free_graph_all()
    return jlm, tlm


def test_mixtral_logits_and_train_step_with_moe_criterion_match_jax():
    """Logits, then three CompiledTrainStep steps of Adam on
    MoECriterion(CrossEntropyLoss()): the same losses, aux and z terms
    included."""
    jlm, tlm = _pair(seed=6, vocab_size=24)
    assert list(tlm.state_dict()) == list(jlm.state_dict())
    seq = RNG.integers(0, 24, (4, 17)).astype(np.int32)
    x, y = seq[:, :16], seq[:, 1:]
    with df.no_grad():
        want = jlm(Tensor(x, device="tpu")).numpy()
    with torch.no_grad():
        np.testing.assert_allclose(tlm(torch.from_numpy(x).long()).numpy(), want, **TOL)
    jcrit = jnn.MoECriterion(jnn.CrossEntropyLoss(), jlm)
    tcrit = tnn.MoECriterion(tnn.CrossEntropyLoss(), tlm)
    assert tcrit.reduction == "mean" and len(tcrit._moes) == 2
    jstep = JaxStep(jlm, joptim.Adam(jlm.parameters(), lr=1e-2), jcrit)
    tstep = CompiledTrainStep(tlm, optim.Adam(tlm.parameters(), lr=1e-2), tcrit)
    want = [float(jstep(x, y)) for _ in range(3)]
    got = [float(tstep(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        tnn.MoECriterion(tnn.CrossEntropyLoss(), tnn.Linear(4, 4, device="cpu"))


def test_fused_adam_takes_the_routers_strided_gradient():
    """Autograd hands the MoE router's weight a strided gradient; fused
    Adam (its kernel takes contiguous tensors) updates it as the unfused
    Adam does."""
    _, a = _pair(seed=8, depth=1, vocab_size=24)
    b = MixtralLM(**dict(CFG, depth=1, vocab_size=24), device="cpu")
    b.load_state_dict(a.state_dict())
    seq = RNG.integers(0, 24, (2, 17)).astype(np.int32)
    losses = {}
    for name, lm, fused in (("unfused", a, False), ("fused", b, True)):
        step = CompiledTrainStep(lm, optim.Adam(lm.parameters(), lr=1e-2, fused=fused),
                                 tnn.MoECriterion(tnn.CrossEntropyLoss(), lm))
        losses[name] = [float(step(seq[:, :16], seq[:, 1:])) for _ in range(3)]
    np.testing.assert_allclose(losses["fused"], losses["unfused"], **TOL)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), **TOL, err_msg=n)


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


@pytest.mark.parametrize("mode", [(None, "f32"), (None, "bf16"), ("int8", "bf16"),
                                  ("w8a8", "bf16")])
def test_decoder_prefill_logits_and_greedy_tokens_match_jax(models, prompts, mode):
    quant, dtype = mode
    jlm, tlm = models
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    jdec = JaxDecoder(jlm, compute_dtype=jdt, quant=quant)
    tdec = KVCacheDecoder(tlm, compute_dtype=tdt, quant=quant)
    assert type(tdec) is MixtralKVCacheDecoder
    B, plen = prompts.shape
    prompt = np.zeros((B, CFG["max_len"]), np.int32)
    prompt[:, :plen] = prompts
    _, _, jlg = jdec._prefill_jit(jdec._prep_jit(jdec._gather()), jnp.asarray(prompt), plen)
    with torch.inference_mode():
        tk, _, tlg = tdec._prefill(tdec._prepared(), torch.as_tensor(prompt).long(), plen)
    assert tk.shape == (2, B, 2, CFG["max_len"], 8)
    jlg = np.asarray(jlg)
    if dtype == "f32":
        np.testing.assert_allclose(tlg.numpy(), jlg, **TOL)
    else:
        err = np.abs(tlg.numpy() - jlg) / np.maximum(1.0, np.abs(jlg))
        assert err.max() < 0.1, err.max()
    np.testing.assert_array_equal(tdec.generate(prompts.copy(), 8),
                                  jdec.generate(prompts.copy(), 8))


@pytest.mark.parametrize("quant", [None, "int8", "w8a8"])
def test_decoder_prep_quantises_attention_and_head_only(models, quant):
    _, tlm = models
    dec = KVCacheDecoder(tlm, compute_dtype=torch.bfloat16, quant=quant)
    p = dec._prepared()
    blk = p["blocks"][0]
    assert blk["router_b"].dtype == torch.float32  # routing stays f32
    for k in ("experts_gate", "experts_up", "experts_down", "router_w"):
        assert blk[k].dtype == torch.bfloat16, k
    if quant is not None:
        key = "w8a8" if quant == "w8a8" else "q"
        for w in (blk["qkv_w"], blk["o_w"], p["head_w"]):
            assert set(w) == {key, "s"} and w[key].dtype == torch.int8
    np.testing.assert_array_equal(
        KVCacheDecoder(tlm).generate(np.ones((1, 3), np.int64), 6),
        tlm.generate(np.ones((1, 3), np.int64), 6))


def test_decoder_mlp_keeps_tied_gates_as_jax(models):
    """Routing ties: with a zero router (weight and bias) every gate ties
    at the k-th value, and both decoders keep all of them (``gates >=
    kth``): the mean of every expert's output."""
    jlm, tlm = models
    jdec, tdec = JaxDecoder(jlm), KVCacheDecoder(tlm)
    jp = jdec._prep_jit(jdec._gather())["blocks"][0]
    tp = tdec._prepared()["blocks"][0]
    jp = dict(jp, router_w=jnp.zeros_like(jp["router_w"]),
              router_b=jnp.zeros_like(jp["router_b"]))
    tp = dict(tp, router_w=torch.zeros_like(tp["router_w"]),
              router_b=torch.zeros_like(tp["router_b"]))
    h = RNG.standard_normal((2, 3, 32)).astype(np.float32)
    want = np.asarray(jdec._mlp(jnp.asarray(h), jp))
    with torch.inference_mode():
        got = tdec._mlp(torch.from_numpy(h), tp).numpy()
        every = (torch.from_numpy(h).reshape(6, 32) @ tp["experts_gate"])  # (E, N, H)
        every = (torch.nn.functional.silu(every)
                 * (torch.from_numpy(h).reshape(6, 32) @ tp["experts_up"])) @ tp["experts_down"]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.reshape(6, 32), every.mean(0).numpy(), **TOL)


def test_load_jax_state_dict_carries_a_bf16_mixtral_bit_for_bit():
    """A bf16 MixtralLM state dict (3-D expert stacks, the router's bias)
    crosses with every bit, and back out of the port unchanged."""
    df.manual_seed(2)
    jlm = jmodels.MixtralLM(**CFG, device="tpu", flash=False).bfloat16()
    sd = jlm.state_dict()
    tlm = MixtralLM(**CFG, device="cpu").bfloat16()
    load_jax_state_dict(tlm, sd)
    tsd = tlm.state_dict()
    assert tsd["blocks.0.moe.experts_gate"].shape == (4, 32, int(32 * 8 / 3))
    assert tsd["blocks.1.moe.router.bias"].shape == (1, 4)
    for k, v in sd.items():
        assert str(v.dtype) == "bfloat16" and tsd[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(tsd[k].view(torch.int16).numpy(),
                                      np.asarray(v).view(np.int16), err_msg=k)
    with pytest.raises(TypeError):  # an f32 model refuses bf16 weights
        load_jax_state_dict(MixtralLM(**CFG, device="cpu"), sd)
