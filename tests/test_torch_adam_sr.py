"""The port's full-bf16 weight training against the JAX package's:
``ops.stochastic_round_bf16`` and the plain twin of ``ops.fused_adam_sr``
(deepflows_tpu_torch/ops/adam.py) against the Pallas ``fused_adam_sr``
(interpret mode on the CPU), the twin's Philox stream, ``optim.Adam(
stochastic_round=True)``, ``Module.bfloat16()`` and a bf16
``load_jax_state_dict``.

Inputs are numpy arrays from seeds.  The Pallas kernel draws threefry bits
in interpret mode; the tests hand the same bits to the port.  Tolerances:
the rounding bit for bit; v and s rtol 1e-6, with an atol of 1e-6 of the
largest value (XLA contracts v·β1 + g·(1-β1) into an FMA, which changes
a value that the sum cancels by more than its own ulp); p within one bf16
ulp, and equal in at least 99.9% of elements (an f32 ulp of the update
can move the carry into the kept bits); SR means within 0.05 ulp of the
exact update (tests/test_pallas.py's bound); the bf16 training test's f32
run within 1e-4 and its RTN run within 2e-2 of JAX's (bf16 rounds at other
places in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxTrainStep
from deepflows_tpu.ops import pallas_kernels as pk
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledTrainStep
from deepflows_tpu_torch.ops.adam import philox4x32_10, philox_bits
from deepflows_tpu_torch.utils import load_jax_state_dict

RNG = np.random.default_rng(53)


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found
    it: later test files in the same process build their models from it."""
    from deepflows_tpu import config
    from deepflows_tpu import random as jrandom
    from deepflows_tpu.backend import jax_kernels, numpy_kernels
    from deepflows_tpu_torch import config as tconfig

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


def _hyper(lr, b1, b2, eps, wd, t):
    return np.asarray([lr, b1, b2, eps, wd, 1 - b1**t, 1 - b2**t], np.float32)


def _bf16_bits(t):
    return t.view(torch.int16).numpy()


def _jax_bits(seed, n):
    """The threefry bits the interpret-mode Pallas kernel draws for an
    n-element parameter: its padded (rows, 128) block, raveled and cut."""
    npad = -(-max(n, 2048) // 2048) * 2048
    rows = -(-(npad // 128) // 512) * 512
    bits = jax.random.bits(jax.random.PRNGKey(seed), (rows, 128), jnp.uint32)
    return np.array(bits).reshape(-1)[:n]


def test_stochastic_round_matches_jax_bit_for_bit():
    n = 20000
    x = (RNG.standard_normal(n) * 10.0 ** RNG.integers(-6, 6, n)).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.5]
    bits = RNG.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    want = pk._stochastic_round_bf16(jnp.asarray(x), jnp.asarray(bits))
    got = ops.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits.view(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), np.asarray(want).view(np.int16))


@pytest.mark.parametrize("gdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,wd", [(1000, 0.0), (5000, 0.01), (70000, 0.01)])
def test_fused_adam_sr_twin_matches_jax_kernel(n, wd, gdt):
    """The plain twin fed the JAX kernel's threefry bits against the kernel
    (interpret mode)."""
    p = RNG.standard_normal(n).astype(np.float32)
    g = (RNG.standard_normal(n) * 1e-2).astype(np.float32)
    v = (RNG.standard_normal(n) * 1e-3).astype(np.float32)
    s = (np.abs(RNG.standard_normal(n)) * 1e-5).astype(np.float32)
    hyper = _hyper(5e-3, 0.9, 0.999, 1e-8, wd, 7)
    seed = 7 * 1009 + 3
    jp = jnp.asarray(p, jnp.bfloat16)
    jg = jnp.asarray(g, getattr(jnp, gdt))
    want = pk.fused_adam_sr(jp, jg, jnp.asarray(v), jnp.asarray(s), jnp.asarray(hyper),
                            jnp.asarray([seed], jnp.int32))
    tp = torch.from_numpy(np.asarray(jp).view(np.int16).copy()).view(torch.bfloat16)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(getattr(torch, gdt))
    tv, ts = torch.from_numpy(v.copy()), torch.from_numpy(s.copy())
    bits = torch.from_numpy(_jax_bits(seed, n).view(np.int32))
    out = ops.fused_adam_sr(tp, tg, tv, ts, torch.from_numpy(hyper),
                            torch.tensor(7, dtype=torch.int32), [3], [bits])
    assert out[0][0] is tp and tp.dtype == torch.bfloat16  # in place
    for got, ref in ((tv, want[1]), (ts, want[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    got = tp.float().numpy()
    ref = np.asarray(want[0], np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() >= 0.999


def test_philox_twin_known_answer_and_streams():
    # Random123's known-answer vector for Philox4x32-10 at counter 0, key 0
    zero = torch.zeros((), dtype=torch.int64)
    words = philox4x32_10(zero, torch.zeros(1, dtype=torch.int64))[0].tolist()
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    t = torch.tensor(5, dtype=torch.int32)
    a = philox_bits(t, 2, 10001)
    assert torch.equal(a, philox_bits(t, 2, 10001))  # deterministic
    assert torch.equal(a[:999], philox_bits(t, 2, 999))  # a prefix of the stream
    for other in (philox_bits(t, 3, 10001), philox_bits(t + 1, 2, 10001)):
        assert (a != other).float().mean() > 0.99  # distinct streams per (t, i)
    assert a.min() >= 0 and a.max() < 2**32
    # the low 16 bits, which the rounding uses, are uniform: mean and the
    # share of each of the 16 bits within 5 standard errors
    big = philox_bits(t, 0, 1 << 18)
    low = (big & 0xFFFF).double()
    assert abs(low.mean().item() - 32767.5) < 5 * 18918.6 / 512
    for b in range(16):
        assert abs(((big >> b) & 1).double().mean().item() - 0.5) < 5 * 0.5 / 512


def test_fused_adam_sr_unbiased():
    """E[SR(x)] = x over 64 steps' Philox streams (tests/test_pallas.py's
    unbiasedness test, with the port's in-kernel generator)."""
    n = 512
    p = torch.tensor(RNG.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    g = torch.full((n,), 1e-4)
    hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001])
    p32 = p.float().double().numpy()
    want = p32 - 1e-3 * (0.1e-4 / 0.1) / (np.sqrt(0.001e-8 / 0.001) + 1e-8)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    acc = np.zeros(n)
    for seed in range(64):
        q, v, s = p.clone(), torch.zeros(n), torch.zeros(n)
        ops.fused_adam_sr(q, g, v, s, hyper, torch.tensor(seed, dtype=torch.int32))
        acc += q.double().numpy()
    assert abs(np.mean((acc / 64 - want) / ulp)) < 0.05
    np.testing.assert_allclose(v.numpy(), np.full(n, 0.1e-4), rtol=1e-6)


def test_adam_sr_escapes_bf16_stall():
    """Round to nearest never moves a bf16 weight by an update below half
    an ulp; stochastic rounding moves it by the expected amount."""
    n, steps, lr = 512, 120, 2e-4  # ulp(1.0) = 2^-8 = 3.9e-3 > 2 lr

    def run(stochastic_round):
        p = torch.nn.Parameter(torch.ones(n, dtype=torch.bfloat16))
        opt = optim.Adam([p], lr=lr, stochastic_round=stochastic_round)
        for _ in range(steps):
            p.grad = torch.ones(n, dtype=torch.bfloat16)
            opt.step()
        assert p.dtype == torch.bfloat16
        return p.detach().float().numpy()

    assert (run(False) == 1.0).all()
    moved = 1.0 - run(True).mean()
    assert 0.5 * lr * steps < moved < 1.5 * lr * steps


def test_bf16_sr_training_recovers_f32_convergence():
    """Module.bfloat16() + Adam(stochastic_round=True) through the port's
    CompiledTrainStep lands near the f32 loss and below round-to-nearest
    (tests/test_pallas.py's test); the f32 and RTN runs agree with JAX's."""
    rng = np.random.default_rng(0)
    xw = rng.standard_normal((256, 16)).astype(np.float32)
    yv = (xw @ rng.standard_normal((16, 4)).astype(np.float32)).argmax(1).astype(np.int32)
    df.manual_seed(0)
    jmodel = jnn.Sequential(jnn.Linear(16, 32, device="tpu"), jnn.ReLU(),
                            jnn.Linear(32, 4, device="tpu"))
    init = {k: v.copy() for k, v in jmodel.state_dict().items()}

    def batches():
        for _ in range(25):
            for b in range(0, 256, 64):
                yield xw[b:b + 64], yv[b:b + 64]

    def jax_run(bf16):
        jmodel.load_state_dict(init)
        jmodel.to_dtype(jnp.float32)
        if bf16:
            jmodel.bfloat16()
        step = JaxTrainStep(jmodel, joptim.Adam(jmodel.parameters(), lr=2e-3),
                            jnn.CrossEntropyLoss())
        return float(np.mean([float(step(x, y)) for x, y in batches()][-4:]))

    def port_run(bf16, sr):
        model = tnn.Sequential(tnn.Linear(16, 32, device="cpu"), tnn.ReLU(),
                               tnn.Linear(32, 4, device="cpu"))
        load_jax_state_dict(model, init)
        if bf16:
            model.bfloat16()
            assert model[0].weight.dtype == torch.bfloat16
        step = CompiledTrainStep(model, optim.Adam(model.parameters(), lr=2e-3,
                                                   stochastic_round=sr),
                                 tnn.CrossEntropyLoss())
        losses = [float(step(x, y)) for x, y in batches()]
        assert all(p.dtype == (torch.bfloat16 if bf16 else torch.float32)
                   for p in model.parameters())
        return float(np.mean(losses[-4:]))

    f32, rtn, sr = port_run(False, False), port_run(True, False), port_run(True, True)
    assert sr < rtn, (sr, rtn)
    assert sr < f32 * 2.0, (sr, f32)
    np.testing.assert_allclose(f32, jax_run(False), rtol=1e-4)
    np.testing.assert_allclose(rtn, jax_run(True), rtol=2e-2)


def test_load_jax_state_dict_carries_bf16_exactly():
    df.manual_seed(3)
    jmodel = jnn.Sequential(jnn.Linear(5, 7, device="tpu"), jnn.ReLU(),
                            jnn.Linear(7, 3, device="tpu")).bfloat16()
    state = jmodel.state_dict()
    assert np.asarray(state["0.weight"]).dtype.name == "bfloat16"
    model = tnn.Sequential(tnn.Linear(5, 7, device="cpu"), tnn.ReLU(),
                           tnn.Linear(7, 3, device="cpu")).bfloat16()
    load_jax_state_dict(model, state)
    for name, t in model.state_dict().items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_bits(t), np.asarray(state[name]).view(np.int16))
    f32 = tnn.Sequential(tnn.Linear(5, 7, device="cpu"), tnn.ReLU(),
                         tnn.Linear(7, 3, device="cpu"))
    with pytest.raises(TypeError, match="dtype mismatch"):
        load_jax_state_dict(f32, state)


def test_bfloat16_casts_parameters_and_keeps_buffers():
    model = tnn.Linear(4, 2, device="cpu")
    model.register_buffer("stat", torch.zeros(3))
    weight = model.weight
    assert model.bfloat16() is model
    assert model.weight is weight and weight.dtype == torch.bfloat16
    assert model.stat.dtype == torch.float32
    model.to_dtype(torch.bfloat16, cast_buffers=True)
    assert model.stat.dtype == torch.bfloat16
