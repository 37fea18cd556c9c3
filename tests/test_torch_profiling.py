"""The port's tracing and cost reports (``utils.profiling``) and
``utils.visual`` on the CPU, against the JAX package where it has the
same function.

- ``StepTimer.summary`` equals JAX's for the same times; ``sync_every``
  runs without a card.
- ``device_memory_stats`` is None on the CPU; ``trace`` writes a Chrome
  trace with the block's ops.
- ``step_report`` counts FLOPs with ``FlopCounterMode`` and adds each
  kernel's stated count in place of its plain twin: on an MLP train step
  it gives the analytic matmul count exactly (6·B·Σ in·out less the first
  layer's input gradient, which no one needs; fused Adam states no
  products), on a TransformerLM step with flash attention and the fused
  CE head the analytic count with the kernels' own counts.  JAX's count
  (XLA's cost analysis) also counts elementwise work: on the MLP the
  port's is 0.880 of it (measured here on the CPU), so the test asks for
  a ratio in [0.85, 1.0].  The report puts the step's parameters,
  optimizer state and generator back as they were.
- ``Animator`` records its points and saves a figure (skipped without
  matplotlib).
"""

import json
import os

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph
from deepflows_tpu import nn as jnn
from deepflows_tpu import optim as joptim
from deepflows_tpu.jit import CompiledTrainStep as JaxStep
from deepflows_tpu.utils import profiling as jprof
from deepflows_tpu_torch import models, nn, ops, optim
from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep
from deepflows_tpu_torch.random import generator
from deepflows_tpu_torch.utils import load_jax_state_dict
from deepflows_tpu_torch.utils import profiling as tprof

JAX_RATIO = (0.85, 1.0)  # port FLOPs / JAX FLOPs on the MLP step (measured 0.880)
DIMS = ((20, 64), (64, 32), (32, 5))
B = 32


@pytest.fixture(scope="module", autouse=True)
def _keep_jax_rng():
    """Leave the JAX package's process-global RNG state as this module found it."""
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
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)
    assert not ops._common.RECORDERS


def _mlp(pkg, device="cpu"):
    layers = []
    for i, (a, b) in enumerate(DIMS):
        layers += [pkg.Linear(a, b, device=device)] + ([pkg.ReLU()] if i < len(DIMS) - 1 else [])
    return pkg.Sequential(*layers)


def _batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, DIMS[0][0])).astype(np.float32),
            rng.integers(0, DIMS[-1][1], B).astype(np.int32))


@pytest.mark.parametrize("times", [[0.3], [0.5, 0.1, 0.2, 0.4], list(np.linspace(0.01, 1, 41))])
def test_step_timer_summary_matches_jax(times):
    jt, tt = jprof.StepTimer(), tprof.StepTimer(sync_every=2)
    jt.times, tt.times = list(times), list(times)
    assert tt.summary() == jt.summary()
    assert tprof.StepTimer().summary() == jprof.StepTimer().summary() == {}
    for _ in range(3):
        with tt:
            pass
    assert tt.summary()["steps"] == len(times) + 3


def test_device_memory_stats_is_none_on_the_cpu():
    assert tprof.device_memory_stats("cpu") is None
    assert tprof.device_memory_stats(torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats(0) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with tprof.trace(log_dir) as d:
        assert d == log_dir
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("fused", [False, True])
def test_step_report_mlp_flops_are_the_matmuls(fused):
    x, y = _batch()
    m = _mlp(nn)
    step = CompiledTrainStep(m, optim.Adam(m.parameters(), lr=0.1, fused=fused),
                             nn.CrossEntropyLoss())
    step(x, y)  # a state that is not the init's
    before = {k: v.clone() for k, v in m.state_dict().items()}
    opt_before = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                  for k, v in step.optimizer._state.items()}
    rng_before = generator("cpu").get_state()
    rep = tprof.step_report(step, x, y)
    analytic = 6 * B * sum(a * b for a, b in DIMS) - 2 * B * DIMS[0][0] * DIMS[0][1]
    assert rep["flops_per_step"] == analytic
    assert rep["device_kind"] == "cpu" and "roofline_ms" not in rep
    assert rep["bytes_per_step"] > 0 and rep["summary"].endswith("GB/step")
    assert ("fused_adam" in rep["kernels"]) == fused
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in step.optimizer._state.items():
        if isinstance(v, list):
            assert all(torch.equal(a, b) for a, b in zip(v, opt_before[k])), k
        else:
            assert torch.equal(v, opt_before[k])
    assert torch.equal(generator("cpu").get_state(), rng_before)
    # the next step starts from the state before the report
    with torch.no_grad():
        want = float(nn.CrossEntropyLoss()(m(torch.tensor(x)), torch.tensor(y)))
    assert float(step(x, y)) == pytest.approx(want, rel=1e-6)


def test_step_report_flops_against_jax():
    x, y = _batch()
    df.manual_seed(0)
    jm = _mlp(jnn)
    tm = load_jax_state_dict(_mlp(nn), jm.state_dict())
    jrep = jprof.step_report(JaxStep(jm, joptim.Adam(jm.parameters(), lr=0.1),
                                     jnn.CrossEntropyLoss()), x, y)
    trep = tprof.step_report(CompiledTrainStep(tm, optim.Adam(tm.parameters(), lr=0.1),
                                               nn.CrossEntropyLoss()), x, y)
    ratio = trep["flops_per_step"] / jrep["flops_per_step"]
    assert JAX_RATIO[0] <= ratio <= JAX_RATIO[1], ratio


def test_step_report_counts_the_kernels_not_their_twins():
    """A TransformerLM step with flash attention and the fused CE head: the
    twins' matmuls on the CPU are left out, the kernels' stated counts go in
    (flash: 2 products forward and 5 backward over the causal pairs; CE: the
    logits forward, and the logits again, dx and dw backward)."""
    V, L, D, depth, H, Bb = 50, 16, 32, 2, 4, 2
    torch.manual_seed(0)
    lm = models.TransformerLM(V, max_len=L, dim=D, depth=depth, num_heads=H, device="cpu",
                              flash=True)
    step = CompiledTrainStep(lm.trunk(), optim.Adam(lm.parameters(), lr=1e-3, fused=True),
                             nn.LMHeadCrossEntropy(lm.head))
    rng = np.random.default_rng(1)
    xi, yi = rng.integers(0, V, (Bb, L)), rng.integers(0, V, (Bb, L))
    rep = tprof.step_report(step, xi, yi)
    T, pairs = Bb * L, L * (L + 1) // 2
    flash = depth * Bb * H * pairs * (D // H)
    assert rep["kernels"]["flash_attention_fwd"] == dict(
        calls=depth, flops=4 * flash, bytes=depth * (4 * Bb * L * D * 4 + 4 * Bb * H * L))
    assert rep["kernels"]["flash_attention_bwd"]["flops"] == 10 * flash
    assert rep["kernels"]["fused_linear_ce_fwd"]["flops"] == 2 * T * D * V
    assert rep["kernels"]["fused_linear_ce_bwd"]["flops"] == 6 * T * D * V
    assert rep["flops_per_step"] == 3 * 2 * T * 12 * D * D * depth + 8 * T * D * V + 14 * flash
    # an eval step: the forward alone, nothing to restore
    erep = tprof.step_report(CompiledEvalStep(lm), xi)
    assert erep["flops_per_step"] == 2 * T * 12 * D * D * depth + 2 * T * D * V + 4 * flash
    assert erep["kernels"]["flash_attention_fwd"]["calls"] == depth


def test_animator_records_and_saves(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    from deepflows_tpu.utils.visual import Animator as JaxAnimator
    from deepflows_tpu_torch.utils.visual import Animator

    a, j = Animator(xlabel="epoch", legend=["loss", "acc"]), JaxAnimator(legend=["loss", "acc"])
    for e in range(3):
        a.add(e, [1.0 / (e + 1), 0.5 + 0.1 * e])
        j.add(e, [1.0 / (e + 1), 0.5 + 0.1 * e])
    a.add(3, [None, 0.9])
    j.add(3, [None, 0.9])
    assert a.X == j.X and a.Y == j.Y and len(a.X[1]) == 4 and len(a.X[0]) == 3
    path = str(tmp_path / "curve.png")
    a.save(path)
    assert os.path.getsize(path) > 0
    import matplotlib.pyplot as plt

    plt.close("all")
