"""The port's ring attention (``parallel.ring_attention``) on 4 gloo ranks
against the JAX package's on 4 virtual devices, and its route in
``nn.MultiheadAttention``.

On a {data: 2, model: 2} mesh (``tests/torch_parallel_ranks.py``, cases
``ring``, ``ring_memory`` and ``ring_lm``):

- forward against the JAX package's ring and the naive attention, causal
  and not, f32 (rtol 2e-5 / atol 2e-6, the JAX test's bound); gradients of
  ``sum(out · w)`` for q, k and v, causal and not; a bf16 causal ring,
  forward and gradients (rtol 2e-2, its dtype kept);
- a DTensor refused (the ring takes the plain tensors each rank holds
  whole, as ``ShardedTrainStep`` hands them);
- the largest tensor a rank makes: the ring's ``(B, H, L/P, L/P)`` block
  against the gathered attention's ``(B, H, L, L)`` scores on {model: 4}
  (the counterpart of the JAX test's compiled temp bytes);
- ``TransformerLM(ring=(mesh, "model"))`` trained 3 steps by
  ``ShardedTrainStep`` against the unsharded LM without a ring and the JAX
  package's ring LM (within 1e-4 of the loss, the JAX test's bound).

Single-process: a window with a ring raises as in the JAX package; grouped
heads, ``need_weights`` and live attention dropout take the other routes.
"""

import numpy as np
import pytest

import deepflows_tpu as df
from deepflows_tpu import Graph

import torch_parallel_ranks as ranks

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


@pytest.fixture(autouse=True)
def _clean():
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)


def _qkvw(seed, B, H, L, D, grads):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, H, L, D)).astype(np.float32)
                 for _ in range(4 if grads else 3))


def _inputs():
    cases = {}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        q, k, v = _qkvw(0, 4, 2, 32, 16, False)
        cases[f"f32_{tag}"] = (q, k, v, None, causal, "f32")
        q, k, v, w = _qkvw(1, 2, 2, 16, 8, True)
        cases[f"grad_{tag}"] = (q, k, v, w, causal, "f32")
    q, k, v, w = _qkvw(2, 2, 2, 64, 16, True)
    cases["bf16_causal"] = (q, k, v, w, True, "bf16")
    import deepflows_tpu.models as jmodels

    df.manual_seed(21)
    lm = jmodels.TransformerLM(vocab_size=16, max_len=32, dim=32, depth=2, num_heads=2,
                               device="cpu", flash=False)
    r = np.random.default_rng(6)
    lm_batches = [(r.integers(0, 16, size=(8, 32)).astype(np.int32),
                   r.integers(0, 16, size=(8, 32)).astype(np.int32)) for _ in range(3)]
    return {"ring": {"cases": cases}, "ring_memory": {"lengths": [256, 512]},
            "ring_lm": {"state": {k: np.asarray(v) for k, v in lm.state_dict().items()},
                        "batches": lm_batches}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    w = ranks.World(list(inputs), inputs, tmp_path_factory.mktemp("ring"))
    yield w, inputs
    w.results()


def jax_mesh(axes):
    from deepflows_tpu.parallel import make_mesh

    return make_mesh(axes, jax.devices()[:4])


def close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full_attention(world, causal):
    import jax.numpy as jnp

    from deepflows_tpu.parallel.ring import ring_attention

    w, inputs = world
    key = "f32_causal" if causal else "f32_full"
    q, k, v, _, _, _ = inputs["ring"]["cases"][key]
    mesh = jax_mesh({"data": 2, "model": 2})
    want = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh, "model", causal=causal))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for r in w.case("ring"):
        got = r[key]
        close(got["out"], got["ref"], 2e-5, 2e-6)
        close(got["out"], np.asarray(want), 2e-5, 2e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_grads_match(world, causal):
    import jax.numpy as jnp

    from deepflows_tpu.parallel.ring import ring_attention

    w, inputs = world
    key = "grad_causal" if causal else "grad_full"
    q, k, v, wt, _, _ = inputs["ring"]["cases"][key]
    mesh = jax_mesh({"data": 2, "model": 2})

    def loss(q, k, v):
        return (ring_attention(q, k, v, mesh, "model", causal=causal) * wt).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))
    for r in w.case("ring"):
        got = r[key]
        for a, b, c, name in zip(got["grads"], got["ref_grads"], want, "qkv"):
            close(a, b, 2e-5, 2e-6, f"d{name}")
            close(a, np.asarray(c), 2e-5, 2e-6, f"d{name}")


def test_ring_bf16(world):
    """bf16 Q/K/V: the output in bf16, forward and gradients against the
    naive attention on the same bf16 inputs within 2e-2 (the JAX test's
    bf16 bound)."""
    w, _ = world
    for r in w.case("ring"):
        got = r["bf16_causal"]
        assert got["dtype"] == "torch.bfloat16"
        close(got["out"], got["ref"], 2e-2, 2e-2)
        for a, b, name in zip(got["grads"], got["ref_grads"], "qkv"):
            close(a, b, 2e-2, 2e-2, f"d{name}")


def test_ring_refuses_a_dtensor(world):
    """The ring takes the plain tensors each rank holds whole, as inside
    ShardedTrainStep; a DTensor is refused on every rank."""
    w, _ = world
    for r in w.case("ring"):
        assert r["dtensor_refused"] and "not DTensors" in r["dtensor_refused"]


def test_ring_peak_memory_beats_gathered_attention(world):
    w, _ = world
    for r in w.case("ring_memory"):
        ring1k, naive1k = r[256]
        ring2k, naive2k = r[512]
        assert ring2k < naive2k / 4, (ring2k, naive2k)
        assert ring2k < naive1k, (ring2k, naive1k)
        assert naive2k == 4 * 512 * 512  # the gathered (B, H, L, L) scores


def test_lm_trains_with_ring_attention_matches_single_device(world):
    from deepflows_tpu import models, nn, optim
    from deepflows_tpu.parallel import ShardedTrainStep

    w, inputs = world
    r0 = w.case("ring_lm")[0]
    for rl, pl in zip(r0["ref_losses"], r0["losses"]):
        assert abs(rl - pl) < 1e-4 * max(1.0, abs(rl)), (rl, pl)
    mesh = jax_mesh({"data": 2, "model": 2})
    df.manual_seed(21)  # the weights _inputs gave the port
    lm = models.TransformerLM(vocab_size=16, max_len=32, dim=32, depth=2, num_heads=2,
                              device="cpu", flash=False, ring=(mesh, "model"))
    step = ShardedTrainStep(lm, optim.Adam(lm.parameters(), lr=1e-3),
                            nn.CrossEntropyLoss(), mesh)
    for (x, y), pl in zip(inputs["ring_lm"]["batches"], r0["losses"]):
        jl = float(step(x, y))
        assert abs(jl - pl) < 1e-4 * max(1.0, abs(jl)), (jl, pl)


# ------------------------------------------------------- single process
def test_ring_route_in_multihead_attention():
    from deepflows_tpu_torch import models, nn

    ring = (object(), "model")
    with pytest.raises(ValueError, match="window"):
        nn.MultiheadAttention(16, 2, causal=True, window=4, ring=ring, device="cpu")
    mha = nn.MultiheadAttention(16, 2, causal=True, ring=ring, device="cpu")
    assert mha._use_ring(False, True)
    assert not mha._use_ring(True, True)  # need_weights
    assert not mha._use_ring(False, False)  # cross-attention
    gqa = nn.MultiheadAttention(16, 4, num_kv_heads=2, causal=True, ring=ring, device="cpu")
    assert not gqa._use_ring(False, True)
    drop = nn.MultiheadAttention(16, 2, dropout=0.1, ring=ring, device="cpu")
    assert not drop._use_ring(False, True)
    drop.eval()
    assert drop._use_ring(False, True)
    lm = models.TransformerLM(vocab_size=8, max_len=8, dim=16, depth=1, num_heads=2,
                              device="cpu", ring=ring)
    assert lm.blocks[0].attn.ring == ring
