"""The decoders' per-row forwards (deepflows_tpu_torch/models/decoding.py:
``_forward_multi``, ``_forward_multi_paged``, ``_forward_chunk`` and
``_select_multi``) against the JAX package's, on the CPU, for the three
families: TransformerLM (dim 32, depth 2, 4 heads), LlamaLM (4 query and
2 K/V heads, window 6) and MixtralLM (4 experts, top-2), max_len 32.

Both packages get the same weights (``load_jax_state_dict``) and the same
caches, tokens and per-row positions (numpy, from a seed), mixed so that
one row sits at position 0, one inside the window's reach and one at
max_len - 1.  Logits: f32 within 1e-5 (rtol and atol); bf16 within the
JAX tests' bound, max |Δ| / max(1, |ref|) below LOGIT_TOL (0.1; int8
0.15, w8a8 0.25, tests/test_decoding.py).  The caches after the write:
f32 within 1e-5, bf16 within 2e-2 (w8a8 5e-2: its per-row activation
quantisation may round a value one step apart, as its LOGIT_TOL allows),
every entry not written bit for bit.
The JAX side runs its Pallas kernels in interpret mode, its forwards
jitted (a first eager call compiles every op alone, ten times slower), the
port its kernels' plain twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import models as jmodels
from deepflows_tpu.models.decoding import KVCacheDecoder as JaxDecoder
from deepflows_tpu_torch import ops
from deepflows_tpu_torch.models import KVCacheDecoder, LlamaLM, MixtralLM, TransformerLM
from deepflows_tpu_torch.utils import load_jax_state_dict

L = 32
BASE = dict(vocab_size=48, max_len=L, dim=32, depth=2, num_heads=4)
FAMILIES = {
    "gpt": (jmodels.TransformerLM, TransformerLM, BASE),
    "llama": (jmodels.LlamaLM, LlamaLM, dict(BASE, num_kv_heads=2, window=6)),
    "mixtral": (jmodels.MixtralLM, MixtralLM, dict(BASE, num_kv_heads=2, n_experts=4, top_k=2)),
}
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {None: 0.1, "int8": 0.15, "w8a8": 0.25}
CACHE_TOL = {None: 2e-2, "int8": 2e-2, "w8a8": 5e-2}  # bf16 K/V, rtol and atol
CASES = [(f, None, d) for f in FAMILIES for d in DTYPES] + [("llama", "w8a8", "bf16")]
POSV = np.array([0, 9, L - 1])  # per-row positions: the first, past the window, the last


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
    ops.reset_launch_counts()
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert all(k.launches == 0 for k in ops.KERNELS)  # CPU never launches


_MODELS = {}


def _pair(family):
    if family not in _MODELS:
        jcls, tcls, cfg = FAMILIES[family]
        df.manual_seed(17)
        jlm = jcls(**cfg, device="cpu", flash=False)  # numpy init, seconds faster
        tlm = tcls(**cfg, device="cpu")
        load_jax_state_dict(tlm, jlm.state_dict())
        Graph.free_graph_all()
        _MODELS[family] = jlm, tlm
    return _MODELS[family]


def _decoders(family, quant, dtype):
    jlm, tlm = _pair(family)
    jdt, tdt = DTYPES[dtype]
    jdec = JaxDecoder(jlm, compute_dtype=jdt, quant=quant)
    tdec = KVCacheDecoder(tlm, compute_dtype=tdt, quant=quant)
    assert type(tdec).__name__ == type(jdec).__name__
    with torch.inference_mode():
        tp = tdec._prepared()
    return jdec, jdec._prep_jit(jdec._gather()), tdec, tp


def _cache(rng, shape, dtype):
    """The same cache for both packages: numpy f32 rounded to the compute dtype."""
    a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    t = torch.from_numpy(a).to(DTYPES[dtype][1] or torch.float32)
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0] or jnp.float32), t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check_logits(got, want, quant, dtype):
    got = got.float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() < LOGIT_TOL[quant], err.max()


def _check_cache(got, want, before, written, quant, dtype):
    """The cache after the write: near JAX's where written (``written``, a
    bool mask over (rows, positions) that broadcasts over layers, heads
    and Dh), bit for bit as before everywhere else."""
    got, want, before = got.float().numpy(), _np(want), _np(before)
    tol = 1e-5 if dtype == "f32" else CACHE_TOL[quant]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    keep = ~np.broadcast_to(written[None, :, None, :, None], got.shape)
    np.testing.assert_array_equal(got[keep], before[keep])
    np.testing.assert_array_equal(want[keep], before[keep])


def _shape(dec, rows, length):
    a = dec.lm.blocks[0].attn
    return (len(dec.lm.blocks), rows, a.num_kv_heads, length, a.head_dim)


def _written(rows, length, starts, g=1):
    w = np.zeros((rows, length), bool)
    for r, p in starts:
        w[r, p:p + g] = True
    return w


@pytest.mark.parametrize("family,quant,dtype", CASES)
def test_forwards_match_jax(family, quant, dtype):
    """``_forward_multi``: one step with each row at its own position.
    ``_forward_multi_paged``: the same step over a pool of blocks of 8
    positions, each row's blocks scattered through the pool by its table,
    row 0's table unallocated past its first block (the null block 0).
    ``_forward_chunk``: a 4-token chunk a row from each row's position
    (B 3: JAX's masked select over the position axis; B 1, the window
    ending at max_len - 1: its one dynamic_update_slice).  Logits, and
    the caches after each write."""
    jdec, jp, tdec, tp = _decoders(family, quant, dtype)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 48, 3)
    arange = (jnp.arange(L), torch.arange(L))

    def run(name, jargs, targs, rows, length, written):
        (jk, tk), (jv, tv) = (_cache(rng, _shape(tdec, rows, length), dtype) for _ in range(2))
        jl, jk2, jv2 = jax.jit(getattr(jdec, name))(jp, jk, jv, *jargs, arange[0])
        with torch.inference_mode():
            tl, _, _ = getattr(tdec, name)(tp, tk, tv, *targs, arange[1])
        _check_logits(tl, jl, quant, dtype)
        _check_cache(tk, jk2, jk, written, quant, dtype)
        _check_cache(tv, jv2, jv, written, quant, dtype)
        return tl

    def both(*arrays):
        return ([jnp.asarray(a, jnp.int32) for a in arrays], [torch.as_tensor(a) for a in arrays])

    run("_forward_multi", *both(tok, POSV), 3, L, _written(3, L, enumerate(POSV)))

    bs, nb = 8, L // 8
    tbl = (1 + rng.permutation(3 * nb)).reshape(3, nb)
    tbl[0, 1:] = 0  # row 0 sits at position 0: only its first block is allocated
    written = _written(3 * nb + 1, bs, [(tbl[r, p // bs], p % bs) for r, p in enumerate(POSV)])
    run("_forward_multi_paged", *both(tbl, tok, POSV), 3 * nb + 1, bs, written)

    posv = np.array([0, 7, L - 4])
    toks = rng.integers(0, 48, (3, 4))
    tl = run("_forward_chunk", *both(toks, posv), 3, L, _written(3, L, enumerate(posv), 4))
    assert tl.shape == (3, 4, 48)
    if dtype == "f32" and quant is None:
        run("_forward_chunk", *both(toks[2:], posv[2:]), 1, L, _written(1, L, [(0, L - 4)], 4))


@pytest.mark.parametrize("top_k,top_p", [(None, None), (1, None), (None, 1e-6), (5, 0.9)])
def test_select_multi_matches_jax_per_slot(top_k, top_p):
    """Greedy slots pick JAX's argmax, with and without sampling slots
    beside them; a sampling slot under top_k 1 or a tiny top_p keeps only
    the argmax, so it picks JAX's too; other sampling slots stay in the
    vocabulary and are reproducible under the generator's seed."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 48)).astype(np.float32) * 3
    temp = np.array([0, 0.7, 0, 1.3, 0, 0.9], np.float32)
    topp = np.full(6, top_p or 0.0, np.float32)
    smask = temp > 0
    want = np.asarray(JaxDecoder._select_multi(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp), jnp.asarray(topp),
        jnp.asarray(smask), top_k, True))
    greedy = np.asarray(JaxDecoder._select_multi(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp), jnp.asarray(topp),
        jnp.asarray(smask), top_k, False))
    args = [torch.as_tensor(a) for a in (temp, topp, smask)]
    gen = torch.Generator().manual_seed(5)
    got = KVCacheDecoder._select_multi(torch.as_tensor(logits), gen, *args, top_k, True).numpy()
    np.testing.assert_array_equal(
        KVCacheDecoder._select_multi(torch.as_tensor(logits), None, *args, top_k, False).numpy(),
        greedy)
    np.testing.assert_array_equal(greedy, logits.argmax(-1))
    np.testing.assert_array_equal(got[~smask], want[~smask])
    if top_k == 1 or (top_p is not None and top_p < 1e-3):
        np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 48)).all()
    again = KVCacheDecoder._select_multi(torch.as_tensor(logits), gen.manual_seed(5), *args,
                                         top_k, True).numpy()
    np.testing.assert_array_equal(got, again)
