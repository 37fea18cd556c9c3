"""The port's fused LM-head cross-entropy (deepflows_tpu_torch/ops/fused_ce.py)
and its cross-entropy losses against the JAX package on the CPU, where the
JAX side runs its Pallas ``fused_linear_ce`` in interpret mode and the port
its kernels' plain twins; and the bf16 backward kernel's split over
clusters (``_bwd_plan``) with a model of its arithmetic.

Inputs are numpy arrays from a seed; models cross with
``load_jax_state_dict``.  Tolerances are tests/test_fused_ce.py's: loss
rtol and atol 1e-5, gradients rtol 1e-4 / atol 1e-5, bf16 5e-2; the
fused-head A/B holds losses within 1e-3 relative and head weights within
rtol 1e-4 / atol 1e-5, as there.  The model of the kernel's cluster
arithmetic is held to the plain twin at 2e-2 of each gradient's largest
value (chip_smoke.py's bf16 bound): both round dl to bf16, and their
logits differ only in the order of f32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, Tensor
from deepflows_tpu import models as jmodels
from deepflows_tpu import nn as jnn
from deepflows_tpu.ops import pallas_kernels as pk
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.models import TransformerLM
from deepflows_tpu_torch.ops import fused_ce
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(33)


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


def _operands(n, d, v):
    x = RNG.standard_normal((n, d)).astype(np.float32) * 0.5
    w = RNG.standard_normal((d, v)).astype(np.float32) * 0.1
    b = RNG.standard_normal(v).astype(np.float32) * 0.1
    t = RNG.integers(0, v, n).astype(np.int32)
    return x, w, b, t


@pytest.mark.parametrize("n,d,v", [(100, 64, 300), (128, 128, 1024), (37, 64, 513)])
def test_loss_lse_and_grads_match_jax(n, d, v):
    x, w, b, t = _operands(n, d, v)
    jx, jw, jb, jt = (jnp.asarray(a) for a in (x, w, b, t))
    want_loss, want_lse = pk._flce_fwd_impl(jx, jw, jb, jt, 128, 512)
    got_loss, got_lse = ops.fused_linear_ce_fwd(*(torch.from_numpy(a) for a in (x, w, b, t)))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)
    want = jax.grad(lambda *a: pk.fused_linear_ce(*a, jt).mean(), argnums=(0, 1, 2))(jx, jw, jb)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    ops.fused_linear_ce(tx, tw, tb, torch.from_numpy(t)).mean().backward()
    for name, got, ref in zip("xwb", (tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


def test_bf16_activations_match_jax():
    n, d, v = 64, 64, 200
    x, w, _, t = _operands(n, d, v)
    b = np.zeros(v, np.float32)
    want = pk.fused_linear_ce(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b), jnp.asarray(t))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = ops.fused_linear_ce(tx, tw, tb, torch.from_numpy(t))
    assert got.dtype == torch.float32  # the loss is always f32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=5e-2, atol=5e-2)
    got.mean().backward()  # grads come back in each operand's dtype
    assert (tx.grad.dtype, tw.grad.dtype, tb.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)


def test_negative_target_costs_lse():
    """A negative target matches no class in either package: its loss is
    lse.  (A target in [V, padded V) hits a padded column of the JAX kernel
    and costs 1e30 there; the port gives lse for every target outside
    [0, V).)"""
    x, w, b, t = _operands(8, 16, 40)
    t[3] = -1
    want, _ = pk._flce_fwd_impl(*(jnp.asarray(a) for a in (x, w, b, t)), 128, 512)
    got, lse = ops.fused_linear_ce_fwd(*(torch.from_numpy(a) for a in (x, w, b, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert got[3] == lse[3]
    t[5] = 40
    got, lse = ops.fused_linear_ce_fwd(*(torch.from_numpy(a) for a in (x, w, b, t)))
    assert got[5] == lse[5]


CE_CASES = {
    "int_mean": dict(shape=(12, 7), kw={}),
    "int_sum": dict(shape=(12, 7), kw=dict(reduction="sum")),
    "onehot_mean": dict(shape=(12, 7), kw={}, onehot=True),
    "seq_none": dict(shape=(2, 5, 7), kw=dict(reduction="none")),
    "seq_mean": dict(shape=(2, 5, 7), kw={}),
    "ignore_index": dict(shape=(2, 5, 7), kw=dict(ignore_index=3)),
    "label_smoothing": dict(shape=(12, 7), kw=dict(label_smoothing=0.1)),
    "ignore_and_smoothing": dict(shape=(2, 5, 7), kw=dict(ignore_index=2, label_smoothing=0.2)),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_loss_matches_jax(case):
    spec = CE_CASES[case]
    shape, kw = spec["shape"], spec["kw"]
    logits = RNG.standard_normal(shape).astype(np.float32)
    t = RNG.integers(0, shape[-1], shape[:-1]).astype(np.int64)
    if "ignore_index" in kw:
        t.reshape(-1)[::3] = kw["ignore_index"]
    tgt = np.eye(shape[-1], dtype=np.float32)[t] if spec.get("onehot") else t
    jl = Tensor(logits, device="tpu", requires_grad=True)
    jloss = jnn.CrossEntropyLoss(**kw)(jl, Tensor(tgt, device="tpu"))
    tl = torch.from_numpy(logits).requires_grad_()
    tloss = tnn.CrossEntropyLoss(**kw)(tl, torch.from_numpy(tgt))
    np.testing.assert_allclose(tloss.detach().numpy(), jloss.numpy(), rtol=1e-5, atol=1e-6)
    jloss.sum().backward() if kw.get("reduction") == "none" else jloss.backward()
    tloss.sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), jl.grad.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_lm_head_cross_entropy_matches_jax(reduction):
    V, L = 50, 8
    df.manual_seed(4)
    cfg = dict(vocab_size=V, max_len=L, dim=32, depth=1, num_heads=2)
    jlm = jmodels.TransformerLM(**cfg, device="tpu", flash=False)
    tlm = TransformerLM(**cfg, device="cpu")
    load_jax_state_dict(tlm, jlm.state_dict())
    x = RNG.integers(0, V, (2, L)).astype(np.int32)
    y = RNG.integers(0, V, (2, L)).astype(np.int32)
    jloss = jnn.LMHeadCrossEntropy(jlm.head, reduction)(
        jlm.trunk()(Tensor(x, device="tpu")), Tensor(y, device="tpu"))
    tloss = tnn.LMHeadCrossEntropy(tlm.head, reduction)(tlm.trunk()(torch.from_numpy(x)),
                                                       torch.from_numpy(y))
    assert tuple(tloss.shape) == tuple(jloss.shape)
    np.testing.assert_allclose(tloss.detach().numpy(), jloss.numpy(), rtol=1e-5, atol=1e-5)
    tloss.sum().backward()
    jloss.sum().backward() if reduction == "none" else jloss.backward()
    for name in ("head.weight", "head.bias", "blocks.0.mlp.0.weight", "tok_embed.weight"):
        jp = dict(jlm.named_parameters())[name]
        tp = dict(tlm.named_parameters())[name]
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # the head is a reference, not a child: the criterion has no parameters
    assert list(tnn.LMHeadCrossEntropy(tlm.head).parameters()) == []


def test_fused_head_trains_like_the_unfused_head():
    """The port alone, as tests/test_fused_ce.py does for JAX: lm ->
    logits -> CrossEntropyLoss against lm.trunk() ->
    LMHeadCrossEntropy(lm.head), identical init and batches, 5 Adam steps:
    the losses and the head parameters (updated only through the fused
    kernel's dw and db) agree, and the head moved."""
    V, L = 97, 12
    cfg = dict(vocab_size=V, max_len=L, dim=32, depth=2, num_heads=2, device="cpu",
               flash=False)
    lm_a = TransformerLM(**cfg)
    lm_b = TransformerLM(**cfg)
    lm_b.load_state_dict(lm_a.state_dict())
    w0 = lm_a.head.weight.detach().clone()
    step_a = CompiledTrainStep(lm_a, optim.Adam(lm_a.parameters(), lr=1e-3),
                               tnn.CrossEntropyLoss())
    step_b = CompiledTrainStep(lm_b.trunk(), optim.Adam(lm_b.parameters(), lr=1e-3),
                               tnn.LMHeadCrossEntropy(lm_b.head))
    for i in range(5):
        r = np.random.default_rng(100 + i)
        x = r.integers(0, V, (4, L)).astype(np.int32)
        y = r.integers(0, V, (4, L)).astype(np.int32)
        la, lb = float(step_a(x, y)), float(step_b(x, y))
        assert abs(la - lb) / abs(la) < 1e-3, (i, la, lb)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(lm_b.head, name).detach().numpy(),
                                   getattr(lm_a.head, name).detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert (lm_b.head.weight.detach() - w0).abs().max() > 1e-6


def test_plain_backward_matches_jax_above_d_1024():
    """The bf16 kernel takes D up to 4096 now; its twin against the JAX
    kernel (which takes any D) at D 1536, in f32."""
    n, d, v = 64, 1536, 300
    x, w, b, t = _operands(n, d, v)
    x *= 0.2
    jx, jw, jb, jt = (jnp.asarray(a) for a in (x, w, b, t))
    _, lse = pk._flce_fwd_impl(jx, jw, jb, jt, 128, 512)
    want = jax.grad(lambda *a: pk.fused_linear_ce(*a, jt).mean(), argnums=(0, 1, 2))(jx, jw, jb)
    got = ops.fused_linear_ce_bwd_plain(*(torch.from_numpy(a) for a in (x, w, b, t)),
                                        torch.from_numpy(np.array(lse)),
                                        torch.full((n,), 1.0 / n))
    for name, g, ref in zip("xwb", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


# (N, D, V): the training slice, D across the clusters' 256-column slices
# (C = 1, 1, 2, 3, 4, 6, 8, 16), ragged N and V
PLAN_SHAPES = [(8192, 1024, 8192), (300, 200, 1000), (300, 256, 1000), (300, 257, 1000),
               (100, 700, 300), (1000, 1024, 8000), (48, 1536, 200), (300, 2048, 1000),
               (300, 4096, 1000), (37, 64, 513)]


@pytest.mark.parametrize("n,d,v", PLAN_SHAPES)
def test_bwd_plan_splits_d_and_covers_n_and_v_once(n, d, v):
    """C = ceil(D / 256) blocks a cluster, each owning 256 columns of D; the
    dx clusters' BM-row tiles cover N and the dw clusters' BV-column tiles
    cover V exactly once; the C blocks' partial logits fit the owners'
    slots (csrc/fused_linear_ce.cu bwd::DxTile, DwTile)."""
    c, bm, bv = fused_ce._bwd_plan(n, d, v)
    assert c == -(-d // 256) and bm in (128, 64) and bv in (128, 64)
    cols = np.zeros(c * 256, np.int64)
    for r in range(c):
        cols[256 * r:256 * (r + 1)] += 1
    assert (cols[:d] == 1).all() and 256 * (c - 1) < d
    for size, tile in ((n, bm), (v, bv)):
        cover = np.zeros(-(-size // tile) * tile, np.int64)
        for i in range(-(-size // tile)):
            cover[i * tile:(i + 1) * tile] += 1
        assert (cover[:size] == 1).all()
    assert fused_ce._slots_fit(c, bm, 64, fused_ce._SLOTS["dx", bm])
    assert fused_ce._slots_fit(c, 64, bv, fused_ce._SLOTS["dw", bv])
    if (n, d, v) == (8192, 1024, 8192):  # the slice: the largest tiles, 512 blocks
        assert (c, bm, bv) == (4, 128, 128)


@pytest.mark.parametrize("d", [0, 4097, 8192])
def test_bwd_plan_refuses_d_past_the_clusters(d):
    with pytest.raises(ValueError):
        fused_ce._bwd_plan(64, d, 100)
    assert fused_ce.MAX_DIM == {torch.bfloat16: 4096, torch.float32: 1024}


def _cluster_model(x, w, b, t, lse, g, c):
    """The bf16 backward kernel's arithmetic, written out with torch ops:
    each of c blocks computes partial logits over its 256 columns of D, the
    partials are added in block order, then bias, dl = (softmax - onehot)
    g rounded to bf16, and each block's slice of dx = dl w_slice^T and of
    dw = x_slice^T dl; db sums the f32 dl."""
    xf, wf = x.float(), w.float()
    slices = [slice(256 * r, 256 * (r + 1)) for r in range(c)]
    logits = xf[:, slices[0]] @ wf[slices[0]]
    for sl in slices[1:]:
        logits = logits + xf[:, sl] @ wf[sl]
    logits = logits + b.float()
    v = logits.shape[1]
    onehot = (torch.arange(v)[None, :] == t[:, None]).float()
    dl = (torch.exp(logits - lse[:, None]) - onehot) * g[:, None]
    dlb = dl.to(torch.bfloat16).float()
    dx = torch.cat([dlb @ wf[sl].t() for sl in slices], 1)
    dw = torch.cat([xf[:, sl].t() @ dlb for sl in slices], 0)
    return dx.to(x.dtype), dw.to(w.dtype), dl.sum(0).to(b.dtype)


@pytest.mark.parametrize("n,d,v", [(64, 600, 300), (48, 1536, 200), (40, 256, 129)])
def test_cluster_model_matches_the_plain_backward(n, d, v):
    x, w, b, t = _operands(n, d, v)
    x *= 0.2
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    tb, tt = torch.from_numpy(b).to(torch.bfloat16), torch.from_numpy(t)
    _, lse = ops.fused_linear_ce_plain(tx, tw, tb, tt)
    g = torch.from_numpy(RNG.random(n).astype(np.float32)) / n
    c = fused_ce._bwd_plan(n, d, v)[0]
    got = _cluster_model(tx, tw, tb, tt, lse, g, c)
    want = ops.fused_linear_ce_bwd_plain(tx, tw, tb, tt, lse, g)
    for name, a, ref in zip(("dx", "dw", "db"), got, want):
        assert a.dtype == ref.dtype, name
        scale = ref.float().abs().max().item()
        assert (a.float() - ref.float()).abs().max().item() <= 2e-2 * scale, name


def _offset(a):
    """A contiguous copy of ``a`` whose base lies one element (2 bytes in
    bf16) past a 16-byte aligned address."""
    flat = torch.cat([a.new_zeros(1), a.reshape(-1)])
    assert flat.data_ptr() % 16 == 0
    return flat[1:].view(a.shape)


# (x dtype, D, V, which base lies 2 bytes off, the route)
FWD_ROUTES = [("bf16", 64, 96, None, "wgmma"), ("bf16", 1024, 8192, None, "wgmma"),
              ("bf16", 60, 96, None, "mma"), ("bf16", 64, 90, None, "mma"),
              ("bf16", 64, 8190, None, "mma"), ("bf16", 64, 96, "x", "mma"),
              ("bf16", 64, 96, "w", "mma"), ("f32", 64, 96, None, "f32"),
              ("f32", 60, 90, "x", "f32")]


@pytest.mark.parametrize("dt,d,v,off,route", FWD_ROUTES)
def test_fwd_route_takes_wgmma_where_tma_can_read(dt, d, v, off, route):
    """bf16 x and w that TMA can read (D and V multiples of 8, 16-byte aligned
    bases) take the wgmma forward, every other bf16 call mma.sync, f32 the
    CUDA cores."""
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x, w = torch.zeros(5, d, dtype=dtype), torch.zeros(d, v, dtype=dtype)
    if off == "x":
        x = _offset(x)
        assert x.data_ptr() % 16 == x.element_size() and x.is_contiguous()
    if off == "w":
        w = _offset(w)
        assert w.data_ptr() % 16 == w.element_size() and w.is_contiguous()
    assert fused_ce._fwd_route(x, w) == route


# (N, V): the slice, ragged N and V, a single row block, more tiles than
# splits at a few row blocks, one tile
FWD_PLAN_SHAPES = [(8192, 8192), (8191, 8190), (300, 1000), (300, 8200), (37, 513),
                   (8192, 50000), (16384, 8192), (1, 1), (128, 257)]


@pytest.mark.parametrize("route", ["mma", "wgmma"])
@pytest.mark.parametrize("n,v", FWD_PLAN_SHAPES)
def test_fwd_plan_covers_each_tile_once(n, v, route):
    """Every (row block, vocab tile) pair is one block's exactly once: split
    s takes tiles [s·per, min((s + 1)·per, tiles)), no split is empty, and
    there are at most 16 splits (the kernels' scratch)."""
    splits, per = fused_ce._fwd_plan(n, v, route)
    tile = {"mma": 128, "wgmma": 256}[route]
    tiles, row_blocks = -(-v // tile), -(-n // 128)
    assert 1 <= splits <= 16 and per >= 1
    cover = np.zeros((row_blocks, tiles), np.int64)
    for rb in range(row_blocks):
        for s in range(splits):
            mine = range(s * per, min((s + 1) * per, tiles))
            assert len(mine) > 0
            cover[rb, list(mine)] += 1
    assert (cover == 1).all()
    if route == "mma":  # about two blocks an SM, as the kernel chose before the plan moved
        want = min(-(-264 // row_blocks), tiles, 16)
        assert per == -(-tiles // want)
    else:  # the fewest waves of 132 one-block-an-SM blocks times tiles a split
        cost = min(-(-row_blocks * s // 132) * -(-tiles // s) for s in range(1, min(tiles, 16) + 1))
        assert -(-row_blocks * splits // 132) * per == cost
    if (n, v, route) == (8192, 8192, "wgmma"):  # the slice: 128 blocks of 16 tiles
        assert (splits, per) == (2, 16)


def test_fwd_plan_f32_and_refusals():
    assert fused_ce._fwd_plan(100, 1000, "f32") == (1, 1)
    for args in ((0, 10, "mma"), (10, 0, "wgmma"), (10, 10, "tc")):
        with pytest.raises(ValueError):
            fused_ce._fwd_plan(*args)


def _split_model(x, w, b, t, route):
    """The bf16 forward kernels' arithmetic, written out with torch ops in
    f32: for each vocab split of ``_fwd_plan`` and each of its tiles, in
    steps of 128 columns (one accumulator), the logits plus bias with
    columns past V at -1e30, then the online max, sum-exp and target logit
    of each row; then the splits' partials combined in split order."""
    n, v = x.shape[0], w.shape[1]
    splits, per = fused_ce._fwd_plan(n, v, route)
    tile = {"mma": 128, "wgmma": 256}[route]
    xf, wf, bf = x.float(), w.float(), b.float()
    parts = []
    for s in range(splits):
        m = torch.full((n,), -1e30)
        lsum, st = torch.zeros(n), torch.zeros(n)
        for c0 in range(s * per * tile, min((s + 1) * per * tile, -(-v // tile) * tile), 128):
            cols = torch.arange(c0, c0 + 128)
            live = cols < v
            lg = torch.full((n, 128), -1e30)
            lg[:, live] = xf @ wf[:, cols[live]] + bf[cols[live]]
            hit = live[None, :] & (cols[None, :] == t[:, None])
            st = st + torch.where(hit, lg, 0.0).sum(1)
            m_new = torch.maximum(m, lg.max(1).values)
            e = torch.where(live[None, :], torch.exp(lg - m_new[:, None]), 0.0)
            lsum = lsum * torch.exp(m - m_new) + e.sum(1)
            m = m_new
        parts.append((m, lsum, st))
    mm = torch.stack([p[0] for p in parts]).max(0).values
    ll, ss = torch.zeros(n), torch.zeros(n)
    for m, lsum, st in parts:
        ll = ll + lsum * torch.exp(m - mm)
        ss = ss + st
    lse = mm + torch.log(ll)
    return lse - ss, lse


# (N, D, V): V a tile multiple; V past a partial last tile of both widths;
# more splits than row blocks; several row blocks and splits
@pytest.mark.parametrize("route", ["mma", "wgmma"])
@pytest.mark.parametrize("n,d,v", [(64, 32, 512), (300, 48, 1000), (130, 64, 600),
                                   (20, 16, 1300)])
def test_split_model_matches_the_plain_forward_and_jax(n, d, v, route):
    """The split forward's model against the plain twin (all rows) and the
    JAX kernel (interpret mode), at rtol 1e-5 / atol 1e-5; the targets hold
    the last vocab column (in a partial last tile where V is ragged), V + 3
    and -1, which cost lse in the port (the JAX kernel gives a target in [V,
    its padded V) 1e30, so those rows are held to the twin alone)."""
    x, w, b, t = _operands(n, d, v)
    t[:3] = [v - 1, v + 3, -1]
    tx, tw, tb, tt = (torch.from_numpy(a) for a in (x, w, b, t))
    loss, lse = _split_model(tx, tw, tb, tt, route)
    want_loss, want_lse = ops.fused_linear_ce_plain(tx, tw, tb, tt)
    np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5, atol=1e-5)
    assert loss[1] == lse[1] and loss[2] == lse[2]
    jloss, jlse = pk._flce_fwd_impl(*(jnp.asarray(a) for a in (x, w, b, t)), 128, 512)
    keep = t < v
    np.testing.assert_allclose(loss.numpy()[keep], np.asarray(jloss)[keep], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
