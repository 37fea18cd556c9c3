"""The port's 1F1B and interleaved 1F1B schedules
(``PipelinedTrainStep(schedule="1f1b" | "interleaved_1f1b")``) against the
JAX package's and against the port's own GPipe, on 4 gloo ranks
(``tests/torch_pipeline_ranks.py``) beside the JAX side on 4 of its 8
virtual CPU devices at the same mesh shape, from the same weights.

Cases (the JAX tests' in ``tests/test_pipeline_1f1b.py`` and
``tests/test_pipeline_interleaved.py``): 1F1B over {pipe: 4} against the
unpipelined step and GPipe at M 2, 4, 8 and 16; Linear pre and post;
BatchNorm stages over {data: 2, pipe: 2}; bf16; the bubble fractions; the
activation memory (bytes saved for backward, counted by
``saved_tensors_hooks``) at M 4 and 32; interleaved 1F1B of 8 stages over
{pipe: 4} (v = 2) against GPipe of the same 8 blocks as 4 stages of two at
M 2, 4, 6, 8 and 16, against the unpipelined step, with eval_logits in
logical order; ResNet BasicBlock stages (BatchNorm) interleaved over
{data: 2, pipe: 2} against GPipe over {pipe: 4}; an embedding pre and a
head post with cross-entropy; bf16; steps rebuilt over one live stack.
The schedules' grids (``fwd_decode``, ``bwd_decode``) are checked in this
process.  Tolerances are the JAX tests'.
"""

import numpy as np
import pytest

import deepflows_tpu as df
from deepflows_tpu import Graph, nn

import torch_pipeline_ranks as ranks
from test_torch_pipeline import (_Mesh, close, jax_stack, jax_train, losses_close, mlp_batch,
                                 stage_by_stage, state_of)

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


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
    df.set_grad_enabled(True)
    yield
    Graph.free_graph_all()
    df.set_grad_enabled(True)


def pairs_of(state, S):
    """A stack of S mlp stages as S/2 stages of two (``Linear, ReLU,
    Linear, ReLU``): the same blocks in the same order."""
    w, b = state["stacked_0_0_weight"], state["stacked_1_0_bias"]
    return {"stacked_0_0_weight": w[0::2], "stacked_1_0_bias": b[0::2],
            "stacked_2_2_weight": w[1::2], "stacked_3_2_bias": b[1::2]}


def as_pairs(stacked):
    """Logical stacked (weight, bias) of 8 stages in the pairs' layout."""
    w, b = stacked
    return [w[0::2], b[0::2], w[1::2], b[1::2]]


N_1F1B = [2, 4, 8, 16]
N_INTERLEAVED = [2, 4, 6, 8, 16]


def _inputs():
    mlp4 = state_of(jax_stack("mlp", 4))
    mlp8 = state_of(jax_stack("mlp", 8))
    df.manual_seed(3)
    pre = nn.Linear(8, 16, device="cpu")
    stages4 = jax_stack("mlp", 4)
    post = nn.Linear(16, 4, device="cpu")
    r = np.random.default_rng(7)
    hetero_batches = [(r.standard_normal((16, 8)).astype(np.float32),
                       r.standard_normal((16, 4)).astype(np.float32)) for _ in range(3)]
    df.manual_seed(0)
    emb = nn.Embedding(32, 16, device="cpu")
    il8 = jax_stack("mlp", 8, seed=1)
    head = nn.Linear(16, 32, device="cpu")
    r = np.random.default_rng(5)
    tok_batches = [(r.integers(0, 32, 16).astype(np.int64), r.integers(0, 32, 16).astype(np.int32))
                   for _ in range(3)]
    r = np.random.default_rng(3)
    bb_batches = [(r.standard_normal((8, 8, 8, 8)).astype(np.float32),
                   r.standard_normal((8, 8, 8, 8)).astype(np.float32)) for _ in range(2)]
    return {
        "f1b_single": dict(stage="mlp", S=4, M=4, opt="sgd", state=mlp4,
                           batches=[mlp_batch(16, seed=10 + i) for i in range(3)]),
        "f1b_vs_gpipe": dict(stage="mlp", S=4, opt="sgd", state=mlp4, n_micro=N_1F1B,
                             batches=[mlp_batch(16, seed=20 + i) for i in range(3)]),
        "f1b_hetero": dict(stage="mlp", S=4, M=8, opt="sgd", state=state_of(stages4),
                           pre_post="linear", pre=state_of(pre), post=state_of(post),
                           batches=hetero_batches),
        "f1b_bn": dict(stage="lin_bn", S=2, M=4, opt="sgd05", state=state_of(
            jax_stack("lin_bn", 2, seed=5)), batches=[mlp_batch(16, seed=30 + i)
                                                       for i in range(2)]),
        "f1b_bf16": dict(stage="mlp", S=4, M=4, opt="sgd05", bf16=True,
                         stage_kw=dict(width=32), state=state_of(jax_stack("mlp", 4, 9, width=32)),
                         batches=[mlp_batch(16, 32, seed=40)]),
        "bubbles": {},
        "memory": dict(rows=8, width=64),
        "il_vs_gpipe": dict(stage="mlp", S=8, opt="sgd", state=mlp8, pair_state=pairs_of(mlp8, 8),
                            n_micro=N_INTERLEAVED, batches_by_m={
                                M: [mlp_batch(48 if M == 6 else 16, seed=20 + i)
                                    for i in range(3)] for M in N_INTERLEAVED}),
        "il_single": dict(stage="mlp", S=8, M=8, opt="sgd", state=mlp8,
                          batches=[mlp_batch(16, seed=10 + i) for i in range(3)],
                          eval_x=mlp_batch(16, seed=9)[0]),
        "il_bn": dict(stage="basic", S=4, M=4, opt="adam", stage_kw=dict(ch=8),
                      state=state_of(jax_stack("basic", 4, ch=8)), batches=bb_batches),
        "il_hetero": dict(stage="mlp", S=8, M=8, opt="sgd05", state=state_of(il8),
                          pre_post="embed", vocab=32, width=16, pre=state_of(emb),
                          post=state_of(head), crit="ce", batches=tok_batches),
        "il_bf16": dict(stage="mlp", S=8, M=4, opt="sgd01", bf16=True, state=mlp8,
                        pair_state=pairs_of(mlp8, 8), batches=[mlp_batch(16, seed=7)]),
        "il_relayout": dict(stage="mlp", S=4, opt="sgd", state=mlp4),
    }


jax_side = {}


def jax_runs(inputs):
    """The JAX package's runs of the cases beside the ranks'."""
    out = {"f1b_single": jax_train(inputs["f1b_single"], {"pipe": 4}, "1f1b")[2:],
           "f1b_bn": jax_train(inputs["f1b_bn"], {"data": 2, "pipe": 2}, "1f1b")[2:],
           "il_single": jax_train(inputs["il_single"], {"pipe": 4}, "interleaved_1f1b")[2:]}
    c = inputs["il_hetero"]
    df.manual_seed(0)
    pre = nn.Embedding(32, 16, device="cpu")
    stack = jax_stack("mlp", 8, seed=1)
    post = nn.Linear(16, 32, device="cpu")
    out["il_hetero"] = jax_train(c, {"pipe": 4}, "interleaved_1f1b", stack=stack, pre=pre,
                                 post=post)[2:]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_1f1b")
    inputs = _inputs()
    w = ranks.World(list(inputs), inputs, tmp)
    jax_side.update(jax_runs(inputs))  # while the ranks run
    yield w, inputs
    w.results()


def logical_close(a_list, b_list, rtol, atol):
    for a, b in zip(a_list, b_list):
        close(a, b, rtol, atol)


# ------------------------------------------------------------- 1F1B
def test_1f1b_matches_single_device(world):
    w, _ = world
    got = w.case("f1b_single")
    r0 = got[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    stage_by_stage(r0["stacked"], r0["ref"], 4, 1e-5, 1e-6)
    losses, stacked, _ = jax_side["f1b_single"]
    losses_close(r0["losses"], losses, 1e-5)
    logical_close(r0["stacked"], stacked, 1e-5, 1e-6)
    for r in got[1:]:
        assert r["losses"] == r0["losses"]


@pytest.mark.parametrize("n_micro", N_1F1B)
def test_1f1b_matches_gpipe(world, n_micro):
    w, _ = world
    r = w.case("f1b_vs_gpipe")[0][n_micro]
    losses_close(r["1f1b"]["losses"], r["gpipe"]["losses"], 1e-5)
    logical_close(r["1f1b"]["stacked"], r["gpipe"]["stacked"], 1e-5, 1e-6)


def test_1f1b_hetero_pre_post_matches_single_device(world):
    w, _ = world
    r0 = w.case("f1b_hetero")[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    close(r0["pre"]["weight"], r0["ref"]["0.weight"], 1e-5, 1e-6)
    close(r0["post"]["weight"], r0["ref"]["5.weight"], 1e-5, 1e-6)


def test_1f1b_buffered_bn_stages_match_gpipe(world):
    w, _ = world
    got = w.case("f1b_bn")
    r = got[0]
    assert abs(r["gpipe"]["losses"][-1] - r["1f1b"]["losses"][-1]) < 1e-5
    logical_close(r["1f1b"]["stacked"], r["gpipe"]["stacked"], 1e-5, 1e-6)
    logical_close(r["1f1b"]["buffers"], r["gpipe"]["buffers"], 1e-5, 1e-6)
    losses, stacked, bufs = jax_side["f1b_bn"]
    losses_close(r["1f1b"]["losses"], losses, 1e-5)
    logical_close(r["1f1b"]["stacked"], stacked, 1e-5, 1e-6)
    logical_close(r["1f1b"]["buffers"], bufs, 1e-5, 1e-6)


def test_1f1b_bf16_matches_gpipe_bf16(world):
    w, _ = world
    r = w.case("f1b_bf16")[0]
    lg, l1 = r["gpipe"]["losses"][0], r["1f1b"]["losses"][0]
    assert abs(lg - l1) < 2e-2 * max(1.0, abs(lg))
    assert r["1f1b"]["master_dtypes"] == ["torch.float32"]


def test_1f1b_bubble_fraction_reported(world):
    w, _ = world
    r = w.case("bubbles")[0]
    assert r["1f1b"][0] == pytest.approx(3 / 15)
    assert r["gpipe"][0] == pytest.approx(3 / 15)


def test_1f1b_activation_memory_independent_of_m(world):
    """GPipe holds every microbatch's activations until its backward, so the
    bytes saved for backward grow with M (M 4 -> 32 with the microbatch's
    rows fixed: 8x); 1F1B holds those of the microbatches in flight, at most
    2S - 1 = 7 stage forwards on a rank, and interleaved 1F1B at most
    2Pv = 16 chunk forwards, at M 4 and at M 32 alike (a stage forward's
    bytes, ``unit``, plus one for the head)."""
    w, _ = world
    for k, r in enumerate(w.case("memory")):
        unit = r["unit"]
        assert unit > 0
        assert r[("gpipe", 32)] >= 4 * r[("gpipe", 4)], (k, r)
        for M in (4, 32):
            assert r[("1f1b", M)] <= (min(M, 7) + 1) * unit, (k, M, r)
            assert r[("interleaved_1f1b", M)] <= (16 + 1) * unit, (k, M, r)
        assert r[("1f1b", 32)] < r[("gpipe", 32)] / 2, (k, r)
        assert r[("interleaved_1f1b", 32)] < r[("gpipe", 32)], (k, r)


# ------------------------------------------------------------- interleaved
@pytest.mark.parametrize("n_micro", N_INTERLEAVED)
def test_interleaved_matches_gpipe(world, n_micro):
    """M < P (2), M < C (4), not a multiple of P (6), M == C (8), M > C
    (16)."""
    w, _ = world
    r = w.case("il_vs_gpipe")[0][n_micro]
    losses_close(r["interleaved"]["losses"], r["gpipe"]["losses"], 1e-5)
    logical_close(as_pairs(r["interleaved"]["stacked"]), r["gpipe"]["stacked"], 2e-5, 2e-6)


def test_interleaved_matches_single_device(world):
    w, _ = world
    got = w.case("il_single")
    r0 = got[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    stage_by_stage(r0["stacked"], r0["ref"], 8, 1e-5, 1e-6)
    losses, stacked, _ = jax_side["il_single"]
    losses_close(r0["losses"], losses, 1e-5)
    logical_close(r0["stacked"], stacked, 1e-5, 1e-6)


def test_interleaved_buffered_bn_stages_match_gpipe(world):
    """BasicBlock stages: the EMA once per (chunk, microbatch), BatchNorm on
    the global microbatch over {data: 2, pipe: 2} as on one pipe of 4."""
    w, _ = world
    r = w.case("il_bn")[0]
    for a, b in zip(r["interleaved_1f1b"]["losses"], r["gpipe"]["losses"]):
        assert abs(a - b) < 1e-4 * max(1.0, abs(b))
    logical_close(r["interleaved_1f1b"]["stacked"], r["gpipe"]["stacked"], 1e-4, 1e-5)
    logical_close(r["interleaved_1f1b"]["buffers"], r["gpipe"]["buffers"], 1e-4, 1e-5)


def test_interleaved_hetero_pre_post_matches_single_device(world):
    w, _ = world
    r0 = w.case("il_hetero")[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    close(r0["pre"]["weight"], r0["ref"]["0.weight"], 1e-5, 1e-6)
    close(r0["post"]["weight"], r0["ref"]["9.weight"], 1e-5, 1e-6)
    losses, stacked, _ = jax_side["il_hetero"]
    losses_close(r0["losses"], losses, 1e-5)
    logical_close(r0["stacked"], stacked, 1e-5, 1e-6)


def test_interleaved_bf16_matches_gpipe_bf16(world):
    w, _ = world
    r = w.case("il_bf16")[0]
    lg, li = r["gpipe"]["losses"][0], r["interleaved"]["losses"][0]
    assert abs(lg - li) < 2e-2 * max(1.0, abs(lg))
    assert r["interleaved"]["master_dtypes"] == ["torch.float32"]
    logical_close(as_pairs(r["interleaved"]["stacked"]), r["gpipe"]["stacked"], 2e-2, 2e-3)


def test_interleaved_bubble_fraction(world):
    w, _ = world
    r = w.case("bubbles")[0]
    P_, v, M = 4, 2, 12
    frac, virtual = r["interleaved"]
    assert virtual == v
    assert abs(frac - (P_ - 1) / (v * M + P_ - 1)) < 1e-9
    assert frac < (P_ - 1) / (M + P_ - 1)
    assert abs(r["1f1b"][0] - (P_ - 1) / (M + P_ - 1)) < 1e-9


def test_interleaved_eval_logits_unpermutes(world):
    w, _ = world
    got = w.case("il_single")
    for r in got:
        close(r["eval"], got[0]["ref_eval"], 1e-5, 1e-6)


def test_interleaved_requires_divisible_stages():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch import optim as toptim
    from deepflows_tpu_torch.parallel import PipelinedTrainStep, PipelineStack

    stack = PipelineStack([tnn.Sequential(tnn.Linear(16, 16, device="cpu"), tnn.ReLU())
                           for _ in range(6)])
    with pytest.raises(ValueError, match="divisible"):
        PipelinedTrainStep(stack, toptim.SGD(stack.parameters(), lr=0.1), tnn.MSELoss(),
                           _Mesh(data=2, pipe=4), n_micro=4, schedule="interleaved_1f1b")


def test_rebuilt_steps_compose_the_layout(world):
    """A second interleaved step over the same live stack keeps its rows
    (no second permutation) and a GPipe step puts them back in logical
    order; the optimizer's slots move with them."""
    w, inputs = world
    state = inputs["il_relayout"]["state"]
    for r in w.case("il_relayout"):
        perm = r["perm"]
        assert list(perm) == [0, 2, 1, 3]
        for got, name in zip(r["first"], ["stacked_0_0_weight", "stacked_1_0_bias"]):
            np.testing.assert_array_equal(got, state[name][perm])
        for a, b in zip(r["first"], r["second"]):
            np.testing.assert_array_equal(a, b)
        for a, name in zip(r["restored"], ["stacked_0_0_weight", "stacked_1_0_bias"]):
            np.testing.assert_array_equal(a, state[name])
        assert r["layout"] is None


# ------------------------------------------------------------- the grids
@pytest.mark.parametrize("C, n_pipe, M", [(4, 4, 2), (4, 4, 16), (8, 4, 6), (8, 4, 16),
                                           (12, 1, 4), (4, 2, 5)])
def test_grids_schedule_every_microbatch_once(C, n_pipe, M):
    """Each chunk of each microbatch runs forward once and backward once, on
    its owner, after its inputs arrive: chunk c - 1's forward of it a tick
    earlier or more, chunk c + 1's backward likewise; a rank runs at most one
    forward and one backward a tick; the tick counts and slices are the JAX
    package's (1F1B: M + 2(S - 1); interleaved: forward of chunk c = jP + d
    of microbatch m = gP + r at c + r + gC, backward at 2(C - 1) - c + r +
    gC)."""
    from deepflows_tpu_torch.parallel.pipeline import _gpipe_grid, _interleaved_grid

    ticks = _interleaved_grid(C, n_pipe, M)
    when = {}
    for t, acts in enumerate(ticks):
        for d in range(n_pipe):
            mine = [a for a in acts if a[0] == d]
            assert sum(a[1] == "F" for a in mine) <= 1 and sum(a[1] == "B" for a in mine) <= 1
        for d, kind, c, m in acts:
            assert d == c % n_pipe
            assert (kind, c, m) not in when
            when[(kind, c, m)] = t
    assert len(when) == 2 * C * M
    for c in range(C):
        for m in range(M):
            g, r = divmod(m, n_pipe)
            assert when[("F", c, m)] == c + r + g * C
            assert when[("B", c, m)] == 2 * (C - 1) - c + r + g * C
            if c:
                assert when[("F", c - 1, m)] < when[("F", c, m)]
            if c + 1 < C:
                assert when[("B", c + 1, m)] < when[("B", c, m)]
            assert when[("F", c, m)] <= when[("B", c, m)]
    if C == n_pipe:
        assert len(ticks) == M + 2 * (C - 1)
    fwd, bwd = _gpipe_grid(C, M, lambda c: c)
    assert len(fwd) == len(bwd) == M + C - 1
    assert sorted((c, m) for acts in fwd for _, _, c, m in acts) == \
        sorted((c, m) for c in range(C) for m in range(M))
