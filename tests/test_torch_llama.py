"""The port's Llama-family modules (deepflows_tpu_torch: ``nn.RMSNorm``,
``F.silu``, ``F.topk_mask``, ``nn.MultiheadAttention`` with GQA, RoPE and a
sliding window on the naive path and the flash route, ``models.LlamaLM``)
against the JAX package on the CPU.  The JAX side runs its Pallas flash
kernel in interpret mode, the port its kernels' plain twins.

Weights cross with ``load_jax_state_dict``; inputs are numpy arrays from a
seed.  Tolerances: f32 rtol and atol 1e-4 (tests/test_torch_decoding.py),
gradients through the flash route rtol 1e-3 / atol 1e-4
(tests/test_flash_attention.py's MultiheadAttention bound), bf16 rtol and
atol 0.05 (tests/test_flash_attention.py's bf16 bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
import deepflows_tpu_torch as dt
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu.nn import functional as JF
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.models import LlamaLM
from deepflows_tpu_torch.nn import functional as TF
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(41)
CFG = dict(vocab_size=48, max_len=16, dim=32, depth=2, num_heads=4, num_kv_heads=2)


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


def _rand(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _grads_match(jmod, tmod, rtol, atol, dtype=np.float32):
    tparams = dict(tmod.named_parameters())
    for name, p in jmod.named_parameters():
        np.testing.assert_allclose(
            tparams[name].grad.float().numpy(), np.asarray(p.grad.numpy(), dtype),
            rtol=rtol, atol=atol, err_msg=f"grad of {name}",
        )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_jax(dtype):
    df.manual_seed(0)
    jm = jnn.RMSNorm(16, device="tpu")
    tm = tnn.RMSNorm(16, device="cpu")
    assert tm.eps == jm.eps == 1e-6
    w = _rand((16,)) + 1.0
    jm.load_state_dict({"weight": w})
    load_jax_state_dict(tm, {"weight": w})
    x = _rand((4, 7, 16), 3.0)
    tol = 1e-4
    if dtype == "bf16":
        jm.bfloat16()
        tm.bfloat16()
        x = x.astype(jnp.bfloat16)
        tol = 0.05
    xj = Tensor(x, device="tpu", requires_grad=True)
    out = jm(xj)
    (out * out).sum().backward()
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(tm.weight.dtype).requires_grad_()
    tout = tm(xt)
    (tout * tout).sum().backward()
    assert tout.dtype == tm.weight.dtype
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(out.numpy(), np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(xj.grad.numpy(), np.float32), rtol=tol, atol=tol)
    _grads_match(jm, tm, tol, tol)


def test_silu_matches_jax():
    x = _rand((3, 5, 8), 3.0)
    xj = Tensor(x, device="tpu", requires_grad=True)
    out = JF.silu(xj)
    (out * out).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    tout = tnn.SiLU()(xt)
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), out.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_mask_matches_jax_with_ties(k):
    """Rows with ties at the k-th value keep every tied entry; the mask is
    constant under autograd in both packages."""
    x = np.round(_rand((6, 5)), 1)
    x[0] = [0.5, 0.5, 0.5, 0.1, 0.0]  # three-way tie at the top
    x[1] = [0.3, 0.9, 0.3, 0.3, -1.0]  # tie at the 2nd and 3rd value
    x[2] = 1.0  # all tied
    xj = Tensor(x, device="tpu", requires_grad=True)
    jmask = JF.topk_mask(xj, k)
    (jmask * xj).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    tmask = TF.topk_mask(xt, k)
    (tmask * xt).sum().backward()
    np.testing.assert_array_equal(tmask.detach().numpy(), jmask.numpy())
    assert tmask.detach().numpy()[2].sum() == 5  # the all-tied row keeps all
    np.testing.assert_array_equal(xt.grad.numpy(), xj.grad.numpy())  # = the mask
    with pytest.raises(ValueError):
        TF.topk_mask(xt, 6)


ATTN = {  # MultiheadAttention(32, 4, ...) options
    "gqa_rope_window": dict(num_kv_heads=2, rope=True, causal=True, window=4),
    "gqa_one_kv_head": dict(num_kv_heads=1, causal=True),
    "rope_noncausal": dict(rope=True),
    "window_one": dict(causal=True, window=1),
}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("case", list(ATTN))
def test_attention_matches_jax(case, flash):
    """Output, input and parameter gradients, L 12 with a window of 4 and
    of 1 that cut the band, on the naive path and the flash route (K/V
    repeated to every head before the kernel)."""
    B, L, E, H = 2, 12, 32, 4
    kw = dict(ATTN[case], bias=False)
    x = _rand((B, L, E))
    df.manual_seed(3)
    jm = jnn.MultiheadAttention(E, H, device="tpu", flash=flash, **kw)
    tm = tnn.MultiheadAttention(E, H, device="cpu", flash=flash, **kw)
    load_jax_state_dict(tm, jm.state_dict())
    assert tm._use_flash(False, L) is flash
    xj = Tensor(x, device="tpu", requires_grad=True)
    jout = jm(xj)
    (jout * jout).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    tout = tm(xt)
    (tout * tout).sum().backward()
    gtol = (1e-3, 1e-4) if flash else (1e-4, 1e-4)
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), rtol=gtol[0], atol=gtol[1])
    _grads_match(jm, tm, *gtol)


def test_attention_bf16_flash_route_matches_jax():
    """The training path's case: bf16 GQA with RoPE (tables cast to bf16)
    and a window, through the flash route."""
    B, L, E, H = 2, 16, 64, 4
    kw = dict(num_kv_heads=2, rope=True, causal=True, window=4, bias=False, flash=True)
    x = _rand((B, L, E)).astype(jnp.bfloat16)
    df.manual_seed(5)
    jm = jnn.MultiheadAttention(E, H, device="tpu", **kw)
    tm = tnn.MultiheadAttention(E, H, device="cpu", **kw)
    load_jax_state_dict(tm, jm.state_dict())
    jm.bfloat16()
    tm.bfloat16()
    xj = Tensor(x, device="tpu", requires_grad=True)
    jout = jm(xj)
    (jout * jout).sum().backward()
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().requires_grad_()
    tout = tm(xt)
    (tout * tout).sum().backward()
    assert tout.dtype == torch.bfloat16 and tm.q_proj.weight.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(jout.numpy(), np.float32), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(xj.grad.numpy(), np.float32), rtol=0.05, atol=0.05)


def test_rope_tables_are_jax_tables_in_x_dtype():
    m = tnn.MultiheadAttention(32, 4, rope=True, rope_theta=500.0, device="cpu")
    x = torch.zeros((1, 4, 9, 8), dtype=torch.bfloat16)
    m._apply_rope(x, 9)
    cos, sin = m._rope_cache[(9, torch.bfloat16, x.device)]
    assert cos.dtype == torch.bfloat16 and cos.shape == (9, 8)
    ang = np.arange(9)[:, None] / 500.0 ** (np.arange(4) * 2.0 / 8)
    np.testing.assert_array_equal(
        sin.float().numpy(),
        torch.from_numpy(np.tile(np.sin(ang), 2).astype(np.float32)).bfloat16().float().numpy(),
    )


def _llama_pair(seed=5, **kw):
    df.manual_seed(seed)
    cfg = dict(CFG, window=4, **kw)
    jlm = jmodels.LlamaLM(**cfg, device="tpu", flash=False)
    tlm = LlamaLM(**cfg, device="cpu", flash=False)
    load_jax_state_dict(tlm, jlm.state_dict())
    return jlm, tlm


def test_llama_state_dict_and_logits_match_jax():
    jlm, tlm = _llama_pair()
    jsd, tsd = jlm.state_dict(), tlm.state_dict()
    assert list(tsd) == list(jsd)
    assert tsd["blocks.0.attn.k_proj.weight"].shape == (32, 16)  # 2 K/V heads of 8
    assert not any(k.endswith("bias") for k in tsd)  # bias-free, as Llama
    assert tlm.blocks[0].gate.weight.shape == (32, int(32 * 8 / 3))
    idx = RNG.integers(0, 48, (3, 16)).astype(np.int64)
    with df.no_grad():
        want = jlm(Tensor(idx, device="tpu")).numpy()
    with torch.no_grad():
        got = tlm(torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tlm(torch.zeros((1, 17), dtype=torch.long))


def test_llama_train_step_losses_match_jax():
    """Three CompiledTrainStep steps (Adam, CrossEntropyLoss on full
    logits, as the JAX package trains the family): the same losses."""
    jlm, tlm = _llama_pair(seed=6, mlp_ratio=3.5)
    jstep = JaxStep(jlm, joptim.Adam(jlm.parameters(), lr=1e-2), jnn.CrossEntropyLoss())
    tstep = CompiledTrainStep(tlm, optim.Adam(tlm.parameters(), lr=1e-2), tnn.CrossEntropyLoss())
    seq = RNG.integers(0, 48, (4, 17)).astype(np.int32)
    x, y = seq[:, :16], seq[:, 1:]
    want = [float(jstep(x, y)) for _ in range(3)]
    got = [float(tstep(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


def test_llama_remat_raises():
    """remat was refused before it was ported; now LlamaLM(remat=True) builds
    and its logits and gradients equal remat=False's
    (tests/test_torch_remat.py holds the blocks over whole steps)."""
    idx = torch.from_numpy(np.random.default_rng(5).integers(0, CFG["vocab_size"], (2, 9)))
    outs = []
    for remat in (False, True):
        dt.manual_seed(3)
        lm = LlamaLM(**CFG, device="cpu", remat=remat)
        out = lm(idx)
        out.square().sum().backward()
        outs.append((out.detach(), lm.head.weight.grad, lm.tok_embed.weight.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


ARG_CASES = {  # the module, its arguments; both packages must raise alike
    "mha_embed_dim": ("mha", dict(embed_dim=30, num_heads=4)),
    "mha_kv_heads": ("mha", dict(embed_dim=32, num_heads=4, num_kv_heads=3)),
    "mha_rope_odd_head_dim": ("mha", dict(embed_dim=20, num_heads=4, rope=True)),
    "mha_window_not_causal": ("mha", dict(embed_dim=32, num_heads=4, window=4)),
    "mha_window_zero": ("mha", dict(embed_dim=32, num_heads=4, causal=True, window=0)),
    "moe_top_k_above": ("moe", dict(dim=8, hidden=16, n_experts=4, top_k=5)),
    "moe_top_k_negative": ("moe", dict(dim=8, hidden=16, n_experts=4, top_k=-1)),
    "moe_capacity_with_top_k": ("moe", dict(dim=8, hidden=16, n_experts=4, top_k=2,
                                            capacity_factor=1.0)),
    "moe_swiglu_capacity": ("moe", dict(dim=8, hidden=16, n_experts=4, swiglu=True,
                                        capacity_factor=1.0)),
    "moe_capacity_negative": ("moe", dict(dim=8, hidden=16, n_experts=4,
                                          capacity_factor=-1.0)),
}


@pytest.mark.parametrize("case", list(ARG_CASES))
def test_argument_checks_raise_as_jax(case):
    kind, kw = ARG_CASES[case]
    jcls, tcls = {"mha": (jnn.MultiheadAttention, tnn.MultiheadAttention),
                  "moe": (jnn.MoE, tnn.MoE)}[kind]
    with pytest.raises(Exception) as jexc:
        jcls(device="tpu", **kw)
    with pytest.raises(Exception) as texc:
        tcls(device="cpu", **kw)
    assert type(texc.value) is type(jexc.value) is ValueError, (jexc.value, texc.value)
