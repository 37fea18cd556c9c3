"""The training slice as a whole: the port's CompiledTrainStep on
TransformerLM.trunk() with Adam and LMHeadCrossEntropy(lm.head), flash
attention on, against the JAX package's on the CPU.  The JAX side runs its
Pallas kernels in interpret mode, the port its kernels' plain twins.

Models start from the JAX weights (``load_jax_state_dict``); batches are
numpy arrays from seeds.  Tolerances: in f32 every loss of a 20-step
trajectory within 1e-4 relative and the final parameters within rtol 1e-3
/ atol 1e-4 (the same steps, summed in other orders); a JAX run resumed in
the port (weights and Adam state carried across) matches the JAX run
continued, to the same bounds; with bf16 compute the losses agree within
2e-2 relative (bf16 rounds at other places in the two frameworks).
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
from deepflows_tpu.jit import CompiledEvalStep as JaxEvalStep
from deepflows_tpu.jit import CompiledTrainStep as JaxTrainStep
from deepflows_tpu_torch import nn as tnn
from deepflows_tpu_torch import ops, optim
from deepflows_tpu_torch.jit import CompiledEvalStep, CompiledTrainStep
from deepflows_tpu_torch.models import TransformerLM
from deepflows_tpu_torch.utils import load_jax_optimizer_state, load_jax_state_dict

CFG = dict(vocab_size=97, max_len=12, dim=32, depth=2, num_heads=2)
B, STEPS = 4, 20
ADAM = dict(lr=5e-3, weight_decay=5e-4)


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


def _batch(i):
    r = np.random.default_rng(200 + i)
    return (r.integers(0, CFG["vocab_size"], (B, CFG["max_len"])).astype(np.int32),
            r.integers(0, CFG["vocab_size"], (B, CFG["max_len"])).astype(np.int32))


def _jax_lm():
    df.manual_seed(11)
    return jmodels.TransformerLM(**CFG, device="tpu", flash=True)


def _port_lm(jlm):
    tlm = TransformerLM(**CFG, device="cpu", flash=True)
    load_jax_state_dict(tlm, jlm.state_dict())
    return tlm


def _jax_step(jlm, compute_dtype=None):
    return JaxTrainStep(jlm.trunk(), joptim.Adam(jlm.parameters(), **ADAM),
                        jnn.LMHeadCrossEntropy(jlm.head), compute_dtype=compute_dtype)


def _port_step(tlm, fused, compute_dtype=None):
    return CompiledTrainStep(tlm.trunk(), optim.Adam(tlm.parameters(), **ADAM, fused=fused),
                             tnn.LMHeadCrossEntropy(tlm.head), compute_dtype=compute_dtype)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trajectory: initial weights, 20 losses, final weights, and
    what a resume needs: the weights and Adam state after step 3 and the
    weights after step 6."""
    jlm = _jax_lm()
    init = {k: v.copy() for k, v in jlm.state_dict().items()}
    step = _jax_step(jlm)
    losses, snap = [], {}
    for i in range(STEPS):
        losses.append(float(step(*_batch(i))))
        if i + 1 in (3, 6):
            state = step.optimizer.state_dict()["state"]
            snap[i + 1] = ({k: np.array(v) for k, v in jlm.state_dict().items()}, {
                "v": [np.array(a) for a in state["v"]], "s": [np.array(a) for a in state["s"]],
                "t": np.array(state["t"])})
    return init, losses, jlm.state_dict(), snap


@pytest.mark.parametrize("fused", [False, True])
def test_twenty_step_trajectory_matches_jax(jax_run, fused):
    init, want, final, _ = jax_run
    tlm = TransformerLM(**CFG, device="cpu", flash=True)
    load_jax_state_dict(tlm, init)
    step = _port_step(tlm, fused)
    got = [float(step(*_batch(i))) for i in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for name, p in tlm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name], rtol=1e-3, atol=1e-4, err_msg=name)


def test_resume_from_jax_weights_and_adam_state(jax_run):
    """The JAX run's weights and Adam state after step 3 carried across:
    the port's steps 4 to 6 match the JAX run's, losses and weights."""
    _, want, _, snap = jax_run
    (weights, adam), (weights6, _) = snap[3], snap[6]
    tlm = TransformerLM(**CFG, device="cpu", flash=True)
    load_jax_state_dict(tlm, weights)
    tstep = _port_step(tlm, fused=True)
    load_jax_optimizer_state(tstep.optimizer, adam)
    got = [float(tstep(*_batch(i))) for i in range(3, 6)]
    np.testing.assert_allclose(got, want[3:6], rtol=1e-4)
    for name, p in tlm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), weights6[name], rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_bf16_compute_matches_jax():
    jlm = _jax_lm()
    tlm = _port_lm(jlm)
    jstep = _jax_step(jlm, compute_dtype=jnp.bfloat16)
    tstep = _port_step(tlm, fused=True, compute_dtype=torch.bfloat16)
    for i in range(2):
        want = float(jstep(*_batch(i)))
        got = tstep(*_batch(i))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) / want < 2e-2, (i, float(got), want)
    assert all(p.dtype == torch.float32 for p in tlm.parameters())  # the masters


def test_step_contract():
    """lr is read at every call; a subset optimizer leaves the rest alone;
    grad_transform runs before the update; the model is put in train mode;
    accum_steps below 1, or a batch it does not divide, raises; metrics_fn's
    value is kept in ``_last_metrics``."""
    tlm = TransformerLM(**CFG, device="cpu", flash=True)
    trunk = tlm.trunk().eval()
    assert [n for n, _ in trunk.named_parameters()][:2] == ["lm.pos_embed", "lm.tok_embed.weight"]
    head = [tlm.head.weight, tlm.head.bias]
    opt = optim.Adam(head, lr=0.0)
    seen = []

    def transform(grads):
        seen.append(len(grads))
        return grads

    step = CompiledTrainStep(trunk, opt, tnn.LMHeadCrossEntropy(tlm.head),
                             grad_transform=transform)
    assert trunk.training
    before = {k: v.clone() for k, v in tlm.state_dict().items()}
    step(*_batch(0))
    assert seen == [len(list(trunk.parameters()))]
    for k, v in tlm.state_dict().items():  # lr 0: nothing moves
        assert torch.equal(v, before[k]), k
    opt.lr = 1e-2
    step(*_batch(1))
    after = tlm.state_dict()
    assert not torch.equal(after["head.weight"], before["head.weight"])
    assert torch.equal(after["blocks.0.mlp.0.weight"], before["blocks.0.mlp.0.weight"])
    with pytest.raises(ValueError, match="not in the model"):
        CompiledTrainStep(tlm.blocks, opt, tnn.LMHeadCrossEntropy(tlm.head))
    with pytest.raises(ValueError, match="accum_steps"):
        CompiledTrainStep(trunk, opt, tnn.LMHeadCrossEntropy(tlm.head), accum_steps=0)
    x, y = _batch(2)
    with pytest.raises(ValueError, match="not divisible"):
        CompiledTrainStep(trunk, opt, tnn.LMHeadCrossEntropy(tlm.head),
                          accum_steps=x.shape[0] + 1)(x, y)
    step = CompiledTrainStep(trunk, opt, tnn.LMHeadCrossEntropy(tlm.head),
                             metrics_fn=lambda out, y: {"rows": out.shape[0] + 0 * out.sum()})
    step(x, y)
    assert float(step._last_metrics["rows"]) == x.shape[0]


def test_eval_step_and_pipeline_partition_match_jax():
    jlm = _jax_lm()
    tlm = _port_lm(jlm).train()
    x, _ = _batch(0)
    want = np.asarray(JaxEvalStep(jlm)(x))
    got = CompiledEvalStep(tlm)(x)
    assert tlm.training and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    pre, blocks, post = tlm.pipeline_partition()
    h = pre(torch.from_numpy(x))
    for blk in blocks:
        h = blk(h)
    np.testing.assert_allclose(post(h).detach().numpy(), want, rtol=1e-4, atol=1e-4)
    assert pre.pos_embed is tlm.pos_embed and post.head is tlm.head
