"""The port's flash attention (deepflows_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas ``flash_attention``, run in interpret mode
on the CPU, where the port's wrappers take their plain twins.

Inputs are numpy arrays from a seed, handed to both packages.  The JAX side
runs with small blocks (8 to 32) so that its multi-block kernels, with their
causal and window block skipping, are what the port is held against.
Tolerances are tests/test_flash_attention.py's: forward rtol 2e-4 / atol
2e-5, gradients rtol 5e-4 / atol 5e-5, bf16 0.05; MultiheadAttention's
route rtol 1e-3 / atol 1e-4 on its parameter gradients, as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import nn as jnn
from deepflows_tpu.ops import pallas_kernels as pk
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(27)


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


def _rand(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _jax_fwd(q, k, v, causal, window, bq, bk):
    out, res = pk._flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, bq, bk, window
    )
    return np.asarray(out), np.asarray(res[4])[:, : q.shape[2]]


# (q shape, Lk, causal, window, JAX blocks)
CASES = {
    "noncausal": ((2, 2, 64, 32), 64, False, None, (32, 32)),
    "causal": ((2, 2, 64, 32), 64, True, None, (32, 32)),
    "ragged_noncausal": ((1, 3, 40, 16), 40, False, None, (32, 32)),
    "ragged_causal": ((1, 3, 40, 16), 40, True, None, (32, 32)),
    "cross_lq_lt_lk": ((2, 2, 24, 16), 56, False, None, (16, 32)),
    "cross_causal_top_left": ((2, 2, 24, 16), 56, True, None, (16, 32)),
    "causal_lq_gt_lk": ((1, 2, 40, 16), 24, True, None, (8, 8)),
    "window": ((1, 2, 48, 16), 48, True, 5, (16, 16)),
    # rows 16.. see no key (kpos <= qpos - 9 hides all 8 keys): output 0,
    # lse -1e30, as the JAX kernel gives where it skips the whole band
    "fully_masked_rows": ((1, 2, 32, 16), 8, True, 9, (8, 8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    qshape, lk, causal, window, (bq, bk) = CASES[case]
    b, h, lq, d = qshape
    q, k, v = _rand(qshape), _rand((b, h, lk, d)), _rand((b, h, lk, d))
    want_o, want_lse = _jax_fwd(q, k, v, causal, window, bq, bk)
    got_o, got_lse = ops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal, None, window
    )
    assert got_o.dtype == torch.float32 and got_lse.shape == (b * h, lq)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-4, atol=2e-5)
    if case == "fully_masked_rows":
        assert np.all(got_o.numpy()[:, :, 16:] == 0.0)
        assert np.all(got_lse.numpy().reshape(b, h, lq)[:, :, 16:] == -1e30)


def test_custom_scale_matches_jax():
    q, k, v = _rand((1, 2, 32, 16)), _rand((1, 2, 32, 16)), _rand((1, 2, 32, 16))
    want = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, 0.5, 32, 32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              False, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "case", ["noncausal", "causal", "ragged_causal", "cross_causal_top_left", "window",
             "fully_masked_rows"]
)
def test_grads_match_jax(case):
    """dq, dk, dv through the port's autograd.Function against jax.grad of
    the Pallas custom_vjp, with the JAX test's cotangent o·cos(o)."""
    qshape, lk, causal, window, (bq, bk) = CASES[case]
    b, h, lq, d = qshape
    q, k, v = _rand(qshape), _rand((b, h, lk, d)), _rand((b, h, lk, d))

    def jloss(q, k, v):
        o = pk.flash_attention(q, k, v, causal, None, bq, bk, window)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal, None, window)
    (o * torch.cos(o)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5,
                                   err_msg=f"d{name} ({case})")


def test_bf16_matches_jax():
    shape = (1, 2, 64, 32)
    q, k, v = _rand(shape), _rand(shape), _rand(shape)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = pk.flash_attention(*jb, True, None, 32, 32)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*tb, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)
    # and its gradients, in bf16, against the f32 JAX kernel
    def jloss(q, k, v):
        o = pk.flash_attention(q, k, v, True, None, 32, 32)
        return jnp.sum(o * o)

    want_g = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for t in tb:
        t.requires_grad_()
    o = ops.flash_attention(*tb, True)
    (o.float() * o.float()).sum().backward()
    for t, w in zip(tb, want_g):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_route_matches_jax_flash_route(causal):
    """MultiheadAttention(flash=True) in both packages, the same weights:
    same output, same input and parameter gradients."""
    B, L, E, H = 2, 24, 32, 4
    x = _rand((B, L, E))
    df.manual_seed(3)
    jm = jnn.MultiheadAttention(E, H, causal=causal, device="tpu", flash=True)
    tm = tnn.MultiheadAttention(E, H, causal=causal, device="cpu", flash=True)
    load_jax_state_dict(tm, jm.state_dict())
    xt = Tensor(x, device="tpu", requires_grad=True)
    jout = jm(xt)
    (jout * jout).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tm(tx)
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), xt.grad.numpy(), rtol=1e-3, atol=1e-4)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(
            dict(tm.named_parameters())[name].grad.numpy(), p.grad.numpy(),
            rtol=1e-3, atol=1e-4, err_msg=f"grad of {name}",
        )


def test_mha_route_choice():
    """The JAX package's _use_flash rules, with "on a real TPU" read as "on
    the card": flash=True forces the route, need_weights and live attention
    dropout refuse it, flash=None takes it only on the card from L 512."""
    m = tnn.MultiheadAttention(16, 2, device="cpu", flash=True)
    assert m._use_flash(False, 8) and not m._use_flash(True, 8)
    assert not tnn.MultiheadAttention(16, 2, device="cpu")._use_flash(False, 4096)
    assert not tnn.MultiheadAttention(16, 2, device="cpu", flash=False)._use_flash(False, 4096)
    drop = tnn.MultiheadAttention(16, 2, dropout=0.1, device="cpu", flash=True)
    assert not drop._use_flash(False, 8)
    assert drop.eval()._use_flash(False, 8)
    out, w = m(torch.from_numpy(_rand((1, 8, 16))), need_weights=True)
    assert w.shape == (1, 8, 8)


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 1, 4, 160))
    with pytest.raises(ValueError, match="head dims up to 128"):
        ops.flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError):
        ops.flash_attention_fwd(torch.zeros((1, 1, 4, 8)), torch.zeros((1, 1, 4, 8),
                                dtype=torch.bfloat16), torch.zeros((1, 1, 4, 8)))
    with pytest.raises(TypeError):
        ops.flash_attention_fwd(*(torch.zeros((1, 1, 4, 8), dtype=torch.float16),) * 3)


def _heads_view(b, h, l, d, dtype=torch.bfloat16):
    """A (B, L, H, D) tensor seen as (B, H, L, D), as MultiheadAttention
    passes its heads."""
    return torch.zeros((b, l, h, d), dtype=dtype).transpose(1, 2)


def _padded(b, h, l, d, pad, offset=0, dtype=torch.bfloat16):
    """A (B, H, L, D) view into rows of D + pad elements, starting ``offset``
    elements in."""
    return torch.zeros((b, h, l, d + pad), dtype=dtype)[..., offset:offset + d]


@pytest.mark.parametrize("make, route", [
    (lambda: torch.zeros((2, 2, 64, 128), dtype=torch.bfloat16), "wgmma"),
    (lambda: torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16), "wgmma"),
    (lambda: torch.zeros((1, 2, 300, 32), dtype=torch.bfloat16), "wgmma"),
    (lambda: torch.zeros((1, 2, 130, 96), dtype=torch.bfloat16), "wgmma"),
    (lambda: torch.zeros((1, 2, 96, 8), dtype=torch.bfloat16), "wgmma"),
    (lambda: _heads_view(2, 8, 64, 128), "wgmma"),
    (lambda: _heads_view(2, 8, 64, 64), "wgmma"),
    (lambda: _padded(1, 2, 40, 64, 8), "wgmma"),  # rows of 72: still 16-byte multiples
    (lambda: torch.zeros((1, 1, 33, 100), dtype=torch.bfloat16), "mma"),
    (lambda: _padded(1, 2, 40, 64, 4), "mma"),  # rows of 68 elements, 136 bytes
    (lambda: _padded(1, 2, 40, 64, 8, offset=1), "mma"),  # a base 2 bytes off
    (lambda: _padded(1, 2, 40, 128, 4), "mma"),  # rows of 132 elements
    (lambda: _padded(1, 2, 40, 128, 8, offset=1), "mma"),
    (lambda: torch.zeros((2, 2, 64, 128)), "f32"),
    (lambda: _heads_view(2, 8, 64, 64, torch.float32), "f32"),
], ids=["bf16_d128", "bf16_d64", "bf16_d32_ragged", "bf16_d96", "bf16_d8", "bf16_heads_d128",
        "bf16_heads_d64", "bf16_padded_rows", "bf16_d100", "bf16_rows_of_68",
        "bf16_misaligned_base", "bf16_rows_of_132", "bf16_d128_misaligned_base", "f32",
        "f32_heads"])
def test_forward_route(make, route):
    """The forward's kernel follows from dtype, D, strides and alignment:
    bf16 that TMA can read takes wgmma, other bf16 mma.sync, f32 the CUDA
    cores."""
    from deepflows_tpu_torch.ops.flash_attention import _fwd_route

    q = make()
    assert _fwd_route(q, q, q) == route


def test_forward_route_needs_all_three_operands():
    from deepflows_tpu_torch.ops.flash_attention import _fwd_route

    good = torch.zeros((1, 2, 40, 64), dtype=torch.bfloat16)
    bad = _padded(1, 2, 40, 64, 4)
    assert _fwd_route(good, good, good) == "wgmma"
    assert _fwd_route(good, bad, good) == "mma"
    assert _fwd_route(good, good, bad) == "mma"
    broadcast = good[:, :1].expand(1, 2, 40, 64)  # a head stride of 0
    assert _fwd_route(good, broadcast, broadcast) == "mma"


def test_forward_header():
    """The forward's int64 header: after the 20 values of shape, vec and the
    strides of q, k, v and out, the route's code at 20 (the C entry encodes
    the wgmma route's tensor maps from the shape and strides)."""
    import importlib

    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    q = _heads_view(2, 8, 64, 128)
    k = v = torch.zeros((2, 8, 96, 128), dtype=torch.bfloat16)
    for route in fa.ROUTES:
        meta = fa._meta(q, k, True, None, (q, k, v, q), (fa.ROUTES.index(route),))
        assert len(meta) == 21 and fa.ROUTES[meta[20]] == route
        assert list(meta[:8]) == [2, 8, 64, 96, 128, 1, 0, 1]
        assert list(meta[8:11]) == [64 * 8 * 128, 128, 8 * 128]  # q's B, H, L strides
        assert list(meta[11:14]) == [8 * 96 * 128, 96 * 128, 128]


_ALIGNED = {"q": (1, 2, 40, 64), "k": (1, 2, 56, 64), "v": (1, 2, 56, 64), "dout": (1, 2, 40, 64)}


def _bwd_operands(**views):
    """q, k, v and dout, contiguous bf16 (D 64) unless ``views`` gives one."""
    ops_ = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in _ALIGNED.items()}
    ops_.update(views)
    return ops_["q"], ops_["k"], ops_["v"], ops_["dout"]


@pytest.mark.parametrize("operands, route", [
    (lambda: _bwd_operands(), "wgmma"),
    (lambda: (torch.zeros((1, 2, 40, 64)),) * 2 + (torch.zeros((1, 2, 40, 64)),) * 2, "f32"),
    (lambda: (torch.zeros((1, 1, 33, 100), dtype=torch.bfloat16),) * 4, "mma"),
    (lambda: (torch.zeros((1, 2, 96, 8), dtype=torch.bfloat16),) * 4, "wgmma"),
    (lambda: (torch.zeros((1, 3, 200, 96), dtype=torch.bfloat16),) * 4, "wgmma"),
    (lambda: (torch.zeros((2, 2, 64, 128), dtype=torch.bfloat16),) * 4, "wgmma"),
    (lambda: (_heads_view(2, 8, 64, 128),) * 4, "wgmma"),
    (lambda: _bwd_operands(q=_padded(1, 2, 40, 64, 4)), "mma"),
    (lambda: _bwd_operands(q=_padded(1, 2, 40, 64, 8, offset=1)), "mma"),
    (lambda: _bwd_operands(k=_padded(1, 2, 56, 64, 4)), "mma"),
    (lambda: _bwd_operands(k=_padded(1, 2, 56, 64, 8, offset=1)), "mma"),
    (lambda: _bwd_operands(v=_padded(1, 2, 56, 64, 4)), "mma"),
    (lambda: _bwd_operands(v=_padded(1, 2, 56, 64, 8, offset=1)), "mma"),
    (lambda: _bwd_operands(dout=_padded(1, 2, 40, 64, 4)), "mma"),
    (lambda: _bwd_operands(dout=_padded(1, 2, 40, 64, 8, offset=1)), "mma"),
    (lambda: _bwd_operands(dout=_padded(1, 2, 40, 64, 8)), "wgmma"),  # rows of 72
    (lambda: _bwd_operands(k=torch.zeros((1, 1, 56, 64), dtype=torch.bfloat16).expand(
        1, 2, 56, 64), v=torch.zeros((1, 1, 56, 64), dtype=torch.bfloat16).expand(
        1, 2, 56, 64)), "mma"),  # a head stride of 0
], ids=["bf16_d64", "f32", "bf16_d100", "bf16_d8", "bf16_d96", "bf16_d128", "bf16_heads_d128",
        "q_rows_of_68", "q_base_2_bytes_off", "k_rows_of_68", "k_base_2_bytes_off",
        "v_rows_of_68", "v_base_2_bytes_off", "dout_rows_of_68", "dout_base_2_bytes_off",
        "dout_rows_of_72", "broadcast_k_v"])
def test_backward_route(operands, route):
    """The backward's kernel follows from dtype, D, strides and alignment of
    q, k, v and dout: bf16 that TMA can read takes wgmma, other bf16
    mma.sync, f32 the CUDA cores; dout alone can send a call to mma.sync
    whose forward took wgmma."""
    from deepflows_tpu_torch.ops.flash_attention import _bwd_route, _fwd_route

    q, k, v, dout = operands()
    assert _bwd_route(q, k, v, dout) == route
    if route == "mma" and _fwd_route(q, k, v) == "wgmma":
        assert dout.stride(-2) % 8 or dout.data_ptr() % 16


def test_backward_header():
    """The backward's int64 header: after the 29 values of shape, vec and the
    strides of q, k, v, dout, dq, dk and dv, the route's code at 29, then
    out's (B, H, L) strides (the C entry's delta pass reads out), then the
    row length of its f32 scratch: Lq, or Lq rounded up to 128 on the wgmma
    route, where the scratch holds delta and lse·log2e."""
    import importlib

    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    q = dout = _heads_view(2, 8, 64, 128)
    k = v = torch.zeros((2, 8, 96, 128), dtype=torch.bfloat16)
    out = _padded(2, 8, 64, 128, 8)
    grads = (fa._new_like_heads(q), fa._new_like_heads(k), fa._new_like_heads(v))
    for route, want in zip(fa.ROUTES, ((64, 1), (64, 1), (128, 2))):
        ld, planes = fa._stats_layout(route, 64)
        assert (ld, planes) == want
        meta = fa._meta(q, k, True, 3, (q, k, v, dout, *grads),
                        (fa.ROUTES.index(route), *out.stride()[:3], ld))
        assert len(meta) == 34 and fa.ROUTES[meta[29]] == route and meta[33] == ld
        assert list(meta[:8]) == [2, 8, 64, 96, 128, 1, 3, 1]
        assert list(meta[17:20]) == [64 * 8 * 128, 128, 8 * 128]  # dout's B, H, L strides
        assert list(meta[23:26]) == [96 * 8 * 128, 128, 8 * 128]  # dk, laid out (B, L, H, D)
        assert list(meta[30:33]) == [8 * 64 * 136, 64 * 136, 136]  # out's rows of 136


@pytest.mark.parametrize("lq, want", [(1, 128), (70, 128), (128, 128), (129, 256), (1024, 1024)])
def test_backward_stats_rows(lq, want):
    """The wgmma backward's delta and lse·log2e rows are padded to a multiple
    of 128, so every 64- or 128-row tile of them starts 16-byte aligned."""
    from deepflows_tpu_torch.ops.flash_attention import _stats_layout

    assert _stats_layout("wgmma", lq) == (want, 2)
    assert _stats_layout("mma", lq) == (lq, 1)
