"""The port's pipeline parallelism (``deepflows_tpu_torch.parallel.pipeline``)
against the JAX package's: ``PipelineStack``, ``pipeline_apply`` and the
GPipe ``PipelinedTrainStep``, with checkpoints crossing both ways.

The port's side runs on 4 gloo ranks (``tests/torch_pipeline_ranks.py``,
started once for the file in the background) and the JAX side on 4 of its
8 virtual CPU devices at the same mesh shape, from the same weights
(``load_jax_state_dict``) and batches.  Each case also holds the port's
pipelined run against its own unpipelined ``CompiledTrainStep`` over the
same stages (rank 0).  The checks that need no ranks (``pipeline_apply``
against the stages run one after another, every refusal) run in this
process.

Cases (the JAX tests' in ``tests/test_pipeline.py``): MLP stages over
{pipe: 4} with SGD momentum, and eval_logits; Conv/BatchNorm stages over
{data: 2, pipe: 2} against ``accum_steps=M`` (the EMA once a microbatch,
the global microbatch's statistics); the L2-normalising stage; four drawn
Conv/BN/ReLU stacks; bf16 compute; {pipe: 2, model: 2} with
``tensor_parallel_rules``; Linear pre and post; TransformerLM split by
``pipeline_partition`` over {data: 2, pipe: 2}; a checkpoint round trip,
a JAX pipeline file into the port's placed stack and optimizer, the port's
file into the JAX package, an interleaved layout's file, and
``load_jax_state_dict`` into pipe-sharded blocks.  Tolerances are the JAX
tests': losses 1e-5 relative (BN and the LM 1e-4), weights rtol 1e-5 /
atol 1e-6 (BN rtol 1e-4 / atol 1e-5, its buffers atol 1e-6).
"""

import numpy as np
import pytest
import torch

import deepflows_tpu as df
from deepflows_tpu import Graph, models, nn, optim

import torch_pipeline_ranks as ranks

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


# ------------------------------------------------------------- the JAX side
class JaxL2Stage(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.lin = nn.Linear(width, width, device="cpu")

    def forward(self, x):
        y = self.lin(x)
        return y / (y * y).sum(1, True).sqrt()


def jax_stage(kind, width=16, ch=4, **kw):
    if kind == "mlp":
        return nn.Sequential(nn.Linear(width, width, device="cpu"), nn.ReLU())
    if kind == "conv_bn":
        return nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1, bias=False, device="cpu"),
                             nn.BatchNorm2d(ch, device="cpu"), nn.ReLU())
    if kind == "lin_bn":
        return nn.Sequential(nn.Linear(width, width, device="cpu"),
                             nn.BatchNorm1d(width, device="cpu"), nn.ReLU())
    if kind == "l2":
        return JaxL2Stage(width)
    if kind == "basic":
        return models.resnet.BasicBlock(ch, ch, device="cpu")
    if kind == "fuzz":
        mods = [nn.Conv2d(ch, ch, 3, padding=1, bias=not kw["bn"], device="cpu")]
        if kw["bn"]:
            mods.append(nn.BatchNorm2d(ch, device="cpu"))
        if kw["relu"]:
            mods.append(nn.ReLU())
        return nn.Sequential(*mods)
    raise ValueError(kind)


def jax_stages(kind, n, seed=0, **kw):
    df.manual_seed(seed)
    return [jax_stage(kind, **kw) for _ in range(n)]


def jax_stack(kind, n, seed=0, **kw):
    from deepflows_tpu.parallel.pipeline import PipelineStack

    return PipelineStack(jax_stages(kind, n, seed, **kw))


def state_of(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def jax_mesh(axes):
    """The mesh on 4 devices; the JAX step shards the batch over a data axis,
    so one of size 1 goes first where the port's mesh has none."""
    from deepflows_tpu.parallel import make_mesh

    return make_mesh(axes if "data" in axes else {"data": 1, **axes}, jax.devices()[:4])


JAX_OPTS = {
    "sgd": lambda ps: optim.SGD(ps, lr=0.1, momentum=0.9),
    "sgd01": lambda ps: optim.SGD(ps, lr=0.1),
    "sgd05": lambda ps: optim.SGD(ps, lr=0.05),
    "sgd05m": lambda ps: optim.SGD(ps, lr=0.05, momentum=0.9),
    "adam": lambda ps: optim.Adam(ps, lr=1e-3),
    "adam2": lambda ps: optim.Adam(ps, lr=1e-2),
}


def jax_linear_pre_post(seed=3):
    df.manual_seed(seed)
    return nn.Linear(8, 16, device="cpu"), nn.Linear(16, 4, device="cpu")


def jax_train(c, axes, schedule="gpipe", stack=None, pre=None, post=None, **kw):
    """The JAX package's pipelined run of a case: (step, stack, losses,
    stacked weights in logical order, buffers in logical order)."""
    import jax.numpy as jnp

    from deepflows_tpu.parallel.pipeline import PipelinedTrainStep

    if stack is None:
        stack = jax_stack(c["stage"], c["S"], **c.get("stage_kw", {}))
        stack.load_state_dict(c["state"])  # the case's weights, as the port's ranks load them
    params = list(stack.parameters())
    if pre is not None:
        params = list(pre.parameters()) + params + list(post.parameters())
    if c.get("bf16"):
        kw["compute_dtype"] = jnp.bfloat16
    crit = nn.CrossEntropyLoss() if c.get("crit") == "ce" else nn.MSELoss()
    step = PipelinedTrainStep(stack, JAX_OPTS[c["opt"]](params), crit, jax_mesh(axes),
                              n_micro=c["M"], pre=pre, post=post, schedule=schedule, **kw)
    losses = [float(step(x, y)) for x, y in c["batches"]]
    inv = step._stage_inv
    stacked = [np.asarray(p.data.array) for p in stack.parameters()]
    bufs = [np.asarray(b.data.array) for _, b in stack.named_buffers()]
    if inv is not None:
        stacked, bufs = [a[inv] for a in stacked], [b[inv] for b in bufs]
    return step, stack, losses, stacked, bufs


# ------------------------------------------------------------- the cases
def mlp_batch(n=16, width=16, seed=1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, width)).astype(np.float32),
            r.standard_normal((n, width)).astype(np.float32))


def bn_batch(i):
    r = np.random.default_rng(100 + i)
    return (r.standard_normal((16, 4, 8, 8)).astype(np.float32),
            r.standard_normal((16, 4, 8, 8)).astype(np.float32))


def fuzz_case(seed):
    """The JAX fuzz test's draw for ``seed`` (its stages from seed 0)."""
    rng = np.random.default_rng(200 + seed)
    ch = int(rng.choice([2, 4, 8]))
    img = int(rng.choice([4, 8]))
    S = int(rng.choice([2, 4]))
    use_bn = bool(rng.random() < 0.7)
    use_relu = bool(rng.random() < 0.5)
    M = int(rng.choice([2, 4]))
    kw = dict(ch=ch, bn=use_bn, relu=use_relu)
    batches = []
    for i in range(2):
        r = np.random.default_rng(300 + i)
        batches.append((r.standard_normal((M * 4, ch, img, img)).astype(np.float32),
                        r.standard_normal((M * 4, ch, img, img)).astype(np.float32)))
    return dict(stage="fuzz", S=S, M=M, stage_kw=kw, opt="adam", batches=batches,
                state=state_of(jax_stack("fuzz", S, **kw)))


LM_CFG = dict(vocab_size=16, max_len=8, dim=32, depth=2, num_heads=4)


def jax_lm():
    df.manual_seed(11)
    return models.TransformerLM(**LM_CFG, device="cpu", flash=False)


def lm_batches():
    r = np.random.default_rng(5)
    return [(r.integers(0, 16, size=(16, 8)).astype(np.int32),
             r.integers(0, 16, size=(16, 8)).astype(np.int32)) for _ in range(3)]


def _inputs(tmp):
    mlp = state_of(jax_stack("mlp", 4))
    r = np.random.default_rng(7)
    hetero_batches = [(r.standard_normal((16, 8)).astype(np.float32),
                       r.standard_normal((16, 4)).astype(np.float32)) for _ in range(3)]
    pre, post = jax_linear_pre_post()
    rw = np.random.default_rng(0)
    W = rw.standard_normal((32, 32)).astype(np.float32) * 0.3
    xb = rw.standard_normal((32, 32)).astype(np.float32)
    return {
        "apply_mesh": {
            "mlp": dict(stage="mlp", S=4, state=mlp,
                        x=mlp_batch(8)[0].reshape(4, 2, 16)),
            "bn": dict(stage="lin_bn", S=4, state=state_of(jax_stack("lin_bn", 4, 5)),
                       x=mlp_batch(16)[0].reshape(4, 4, 16)),
        },
        "gpipe_mlp": dict(stage="mlp", S=4, M=4, opt="sgd", state=mlp,
                          batches=[mlp_batch(16, seed=10 + i) for i in range(3)],
                          eval_x=mlp_batch(8)[0]),
        "gpipe_bn": dict(stage="conv_bn", S=2, M=4, opt="sgd", state=state_of(
            jax_stack("conv_bn", 2)), batches=[bn_batch(i) for i in range(3)],
            eval_x=bn_batch(9)[0]),
        "bubble": dict(stage="l2", S=4, M=4, opt="sgd05", state=state_of(jax_stack("l2", 4)),
                       batches=[mlp_batch(16)] * 2),
        "fuzz": {s: fuzz_case(s) for s in range(4)},
        "bf16": dict(stage="mlp", S=4, M=4, opt="adam2", bf16=True, stage_kw=dict(width=32),
                     state=state_of(jax_stack("mlp", 4, width=32)),
                     batches=[(xb, np.maximum(xb @ W, 0))] * 30),
        "tp3d": dict(stage="mlp", S=2, M=4, opt="sgd", stage_kw=dict(width=32),
                     state=state_of(jax_stack("mlp", 2, width=32)),
                     batches=[mlp_batch(16, 32, seed=40 + i) for i in range(3)]),
        "hetero": dict(stage="mlp", S=4, M=4, opt="sgd", state=mlp, pre_post="linear",
                       pre=state_of(pre), post=state_of(post), batches=hetero_batches,
                       eval_x=r.standard_normal((16, 8)).astype(np.float32)),
        "lm": dict(cfg=LM_CFG, state=state_of(jax_lm()), M=4, batches=lm_batches()),
        "ckpt": dict(stage="mlp", S=4, M=4, opt="sgd", state=mlp, init_state=mlp,
                     il_state=state_of(jax_stack("mlp", 8)), batches=[mlp_batch(16)],
                     next=mlp_batch(16, seed=77), port_path=str(tmp / "port.pkl"),
                     jax_path=str(tmp / "jax.pkl"), il_path=str(tmp / "il.pkl")),
        "rejections": {},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = _inputs(tmp)
    # the JAX file the port's ranks load: written before they start
    jax_checkpoint(inputs["ckpt"])
    w = ranks.World(list(inputs), inputs, tmp)
    jax_side.update(jax_runs(inputs))  # while the ranks run
    yield w, inputs
    w.results()


jax_side = {}


def jax_runs(inputs):
    """The JAX package's runs of the cases: (losses, stacked, buffers)."""
    from deepflows_tpu.parallel import tensor_parallel_rules

    out = {}
    for name, axes, kw in (("gpipe_mlp", {"pipe": 4}, {}), ("gpipe_bn", {"data": 2, "pipe": 2}, {}),
                           ("bubble", {"pipe": 4}, {}),
                           ("tp3d", {"pipe": 2, "model": 2},
                            {"param_rules": tensor_parallel_rules("model")})):
        out[name] = jax_train(inputs[name], axes, **kw)[2:]
    out["bf16"] = jax_train(dict(inputs["bf16"], batches=inputs["bf16"]["batches"][:3]),
                            {"pipe": 4})[2:]
    pre, post = jax_linear_pre_post()
    out["hetero"] = jax_train(inputs["hetero"], {"pipe": 4}, pre=pre, post=post)[2:]
    out["hetero_pre"] = np.asarray(pre.weight.data.array)
    out["lm"] = jax_lm_losses(inputs["lm"])
    out["il_ckpt"] = jax_interleaved_layout()
    return out


def jax_lm_losses(c):
    from deepflows_tpu.parallel.pipeline import PipelinedTrainStep, PipelineStack

    lm = jax_lm()
    pre, blocks, post = lm.pipeline_partition()
    stack = PipelineStack(blocks)
    params = list(pre.parameters()) + list(stack.parameters()) + list(post.parameters())
    step = PipelinedTrainStep(stack, optim.Adam(params, lr=1e-3), nn.CrossEntropyLoss(),
                              jax_mesh({"data": 2, "pipe": 2}), n_micro=4, pre=pre, post=post)
    return [float(step(x, y)) for x, y in c["batches"]]


def jax_interleaved_layout():
    """The JAX interleaved step's permutation and its stack's rows right
    after construction, by name."""
    from deepflows_tpu.parallel.pipeline import PipelinedTrainStep

    stack = jax_stack("mlp", 8)
    opt = JAX_OPTS["sgd01"](stack.parameters())
    step = PipelinedTrainStep(stack, opt, nn.MSELoss(), jax_mesh({"pipe": 4}), n_micro=4,
                              schedule="interleaved_1f1b")
    return step._stage_perm, {n: np.asarray(p.data.array) for n, p in stack.named_parameters()}


def jax_checkpoint(c):
    """A JAX GPipe run of the checkpoint case, saved after its step; returns
    the loss it goes on to on the next batch."""
    from deepflows_tpu.utils.model_utils import save_checkpoint

    step, stack, _, _, _ = jax_train(c, {"pipe": 4})
    save_checkpoint(stack, step.optimizer, epoch=1, save_path=c["jax_path"])
    jax_checkpoint.next = float(step(*c["next"]))


def close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def losses_close(got, want, tol):
    """The JAX tests' bound: |a - b| < tol · max(1, |b|) at every step."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) < tol * max(1.0, abs(b)), (i, got, want)


def stage_by_stage(stacked, ref, S, rtol, atol, prefix=""):
    """Stacked weights (in ``stacked``'s parameter order) against the
    stages' own, row s against stage s."""
    names = [n for n in ref if n.startswith(f"{prefix}0.")]
    assert len(names) == len(stacked)
    for j, name in enumerate(names):
        leaf = name[len(prefix) + 2:]
        for s in range(S):
            close(stacked[j][s], ref[f"{prefix}{s}.{leaf}"], rtol, atol, f"{s}.{leaf}")


def same_on_every_rank(got, key="losses"):
    for r in got[1:]:
        assert r[key] == got[0][key]


# ------------------------------------------------------------- in-process checks
def port_stack(kind, n, state, **kw):
    return ranks.build_stack(dict(stage=kind, S=n, state=state, stage_kw=kw))


def test_pipeline_apply_matches_sequential():
    from deepflows_tpu_torch.parallel import pipeline_apply

    jstages = jax_stages("mlp", 4)
    stack = port_stack("mlp", 4, state_of(jax_stack("mlp", 4)))
    x, _ = mlp_batch(8)
    got = pipeline_apply(stack.stage_fn(), list(stack.parameters()),
                         torch.from_numpy(x.reshape(4, 2, 16)))
    ref = df.Tensor(x, device="cpu")
    for s in jstages:
        ref = s(ref)
    close(got.detach().numpy().reshape(8, 16), ref.numpy(), 1e-5, 1e-6)
    # differentiable: the gradient reaches every stacked parameter
    got.sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in stack.parameters())


def test_pipeline_apply_on_mesh(world):
    w, _ = world
    for r in w.case("apply_mesh"):
        close(r["mlp"]["out"], r["mlp"]["want"], 1e-5, 1e-6)
        close(r["bn"]["out"], r["bn"]["want"], 1e-5, 1e-6)
        for a, b in zip(r["bn"]["bufs"], r["bn"]["want_bufs"]):
            close(a, b, 1e-5, 1e-6)


def test_pipelined_train_step_matches_single_device(world):
    w, inputs = world
    got = w.case("gpipe_mlp")
    r0 = got[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    stage_by_stage(r0["stacked"], r0["ref"], 4, 1e-5, 1e-6)
    losses, stacked, _ = jax_side["gpipe_mlp"]
    losses_close(r0["losses"], losses, 1e-5)
    for a, b in zip(r0["stacked"], stacked):
        close(a, b, 1e-5, 1e-6)
    same_on_every_rank(got)
    assert all(s == ("S(0)",) for s in r0["specs"].values())
    for r in got:  # each rank stores its own stage
        assert r["local"]["stacked_0_0_weight"] == (1, 16, 16)


def test_eval_logits_matches_forward(world):
    w, _ = world
    got = w.case("gpipe_mlp")
    for r in got:
        close(r["eval"], got[0]["ref_eval"], 1e-5, 1e-6)


def test_heterogeneous_stages_rejected():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch.parallel import PipelineStack

    stages = [tnn.Sequential(tnn.Linear(16, 16, device="cpu"), tnn.ReLU()),
              tnn.Sequential(tnn.Linear(16, 8, device="cpu"), tnn.ReLU())]
    with pytest.raises(ValueError, match="homogeneous"):
        PipelineStack(stages)


def test_buffered_stages_need_buffered_path():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch.parallel import PipelineStack
    from deepflows_tpu_torch.parallel.pipeline import purify_module

    stack = PipelineStack([tnn.Sequential(tnn.Conv2d(4, 4, 3, padding=1, device="cpu"),
                                          tnn.BatchNorm2d(4, device="cpu"))
                           for _ in range(2)])
    with pytest.raises(ValueError, match="buffer-free"):
        purify_module(stack.template)
    assert callable(stack.buffered_stage_fn())


def test_pipelined_bn_stages_match_accumulated_single_device(world):
    w, inputs = world
    got = w.case("gpipe_bn")
    r0 = got[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-4)
    stage_by_stage(r0["stacked"], r0["ref"], 2, 1e-4, 1e-5)
    bnames = [n for n in r0["ref_buffers"] if n.startswith("0.")]
    for j, name in enumerate(bnames):
        for s in range(2):
            close(r0["buffers"][j][s], r0["ref_buffers"][f"{s}.{name[2:]}"], 1e-4, 1e-6)
    close(r0["eval"], r0["ref_eval"], 1e-4, 1e-5)
    assert all(r["eval_kept_buffers"] for r in got)
    losses, stacked, bufs = jax_side["gpipe_bn"]
    losses_close(r0["losses"], losses, 1e-4)
    for a, b in zip(r0["stacked"], stacked):
        close(a, b, 1e-4, 1e-5)
    for a, b in zip(r0["buffers"], bufs):
        close(a, b, 1e-4, 1e-6)
    same_on_every_rank(got)


def test_shape_changing_stage_rejected():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch.parallel import PipelineStack, pipeline_apply

    stack = PipelineStack([tnn.Sequential(tnn.Linear(16, 8, device="cpu")) for _ in range(2)])
    calls = []
    fn = stack.stage_fn()

    def counted(params, x):
        calls.append(1)
        return fn(params, x)

    with pytest.raises(ValueError, match="preserve activation shape"):
        pipeline_apply(counted, list(stack.parameters()), torch.zeros(2, 4, 16))
    assert len(calls) == 1  # refused at the first stage call, before it went on


def test_pipeline_stack_checkpoint_roundtrip(world):
    w, _ = world
    for r in w.case("ckpt"):
        for a, b in zip(r["saved"], r["reloaded"]):
            close(b, a, 1e-6, 0)
        l1, l2 = r["next"]
        assert abs(l1 - l2) < 1e-5 * max(1.0, abs(l1))


def test_jax_pipeline_checkpoint_loads_into_the_placed_stack(world):
    """A JAX pipeline checkpoint loads into the port's pipe-sharded stack and
    optimizer bit for bit (each rank its block) and trains on to the JAX
    run's next loss."""
    import pickle

    w, inputs = world
    with open(inputs["ckpt"]["jax_path"], "rb") as f:
        ck = pickle.load(f)
    names = sorted(ck["model_parameters"], key=lambda n: int(n.split("_")[1]))
    for r in w.case("ckpt"):
        for got, name in zip(r["from_jax"], names):
            np.testing.assert_array_equal(got, ck["model_parameters"][name])
        for got, want in zip(r["from_jax_v"], ck["optimizer_state"]["full_state"]["v"]):
            np.testing.assert_array_equal(got, np.asarray(want))
        assert r["from_jax_blocks"] == [(1, 16, 16), (1, 1, 16)]
        assert abs(r["from_jax_next"] - jax_checkpoint.next) < 1e-5 * max(
            1.0, abs(jax_checkpoint.next))


def test_port_pipeline_checkpoint_loads_into_jax(world):
    """The port's file (the sharded stack gathered whole) loads into the JAX
    package's stack and optimizer bit for bit and trains on to the port's
    next loss."""
    from deepflows_tpu.parallel.pipeline import PipelinedTrainStep
    from deepflows_tpu.utils.model_utils import load_checkpoint

    w, inputs = world
    r0 = w.case("ckpt")[0]
    stack = jax_stack("mlp", 4, seed=9)
    opt = JAX_OPTS["sgd"](stack.parameters())
    load_checkpoint(stack, opt, load_path=inputs["ckpt"]["port_path"])
    for got, want in zip(stack.parameters(), r0["saved"]):
        np.testing.assert_array_equal(np.asarray(got.data.array), want)
    step = PipelinedTrainStep(stack, opt, nn.MSELoss(), jax_mesh({"pipe": 4}), n_micro=4)
    loss = float(step(*inputs["ckpt"]["next"]))
    assert abs(loss - r0["next"][0]) < 1e-5 * max(1.0, abs(loss))


def test_interleaved_checkpoint_holds_the_permuted_stacking(world):
    """An interleaved step stores its rows round-robin-permuted in both
    packages: the port's file right after construction holds the JAX
    package's permuted rows bit for bit."""
    import pickle

    w, inputs = world
    w.case("ckpt")
    c = inputs["ckpt"]
    with open(c["il_path"], "rb") as f:
        port = pickle.load(f)["model_parameters"]
    perm, theirs = jax_side["il_ckpt"]
    assert list(perm) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert list(port) == list(theirs)
    for name, arr in theirs.items():
        np.testing.assert_array_equal(port[name], arr)
        np.testing.assert_array_equal(port[name], c["il_state"][name][perm])


def test_load_jax_state_dict_into_pipe_sharded_blocks(world):
    w, inputs = world
    state = inputs["ckpt"]["init_state"]
    names = sorted(state, key=lambda n: int(n.split("_")[1]))
    for k, r in enumerate(w.case("ckpt")):
        for got, name in zip(r["blocks"], names):
            np.testing.assert_array_equal(got, state[name][k:k + 1])


def test_bubble_ticks_do_not_poison_grads(world):
    w, inputs = world
    got = w.case("bubble")
    r0 = got[0]
    assert all(np.isfinite(v) for v in r0["losses"])
    assert all(np.all(np.isfinite(a)) for a in r0["stacked"]), "NaN params"
    losses, _, _ = jax_side["bubble"]
    losses_close(r0["losses"], losses, 1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_random_stage_stacks_match_accum(world, seed):
    w, inputs = world
    c = inputs["fuzz"][seed]
    r0 = w.case("fuzz")[0][seed]
    losses_close(r0["losses"], r0["ref_losses"], 1e-4)
    stage_by_stage(r0["stacked"], r0["ref"], c["S"], 1e-4, 1e-5)


def test_structurally_different_stages_rejected():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch.parallel import PipelineStack

    stages = [tnn.Sequential(tnn.Conv2d(2, 2, 3, padding=1, device="cpu")),
              tnn.Sequential(tnn.Conv2d(2, 2, 3, padding=1, device="cpu"), tnn.ReLU())]
    with pytest.raises(ValueError, match="homogeneous"):
        PipelineStack(stages)


def test_config_differing_stages_rejected():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch.parallel import PipelineStack

    stages = [tnn.Sequential(tnn.Conv2d(2, 2, 3, padding=1, device="cpu"),
                             tnn.BatchNorm2d(2, momentum=m, device="cpu")) for m in (0.1, 0.01)]
    with pytest.raises(ValueError, match="homogeneous"):
        PipelineStack(stages)
    acts = [tnn.Sequential(tnn.Linear(4, 4, device="cpu"), tnn.LeakyReLU(s)) for s in (0.1, 0.2)]
    with pytest.raises(ValueError, match="homogeneous"):
        PipelineStack(acts)


def test_pipelined_bf16_mixed_precision(world):
    w, inputs = world
    r0 = w.case("bf16")[0]
    bf16, f32 = r0["bf16"], r0["f32"]
    assert bf16[-1] < 0.6 * bf16[0]  # converges
    assert abs(bf16[-1] - f32[-1]) < 0.15 * max(f32[0], 1e-3)  # tracks f32
    assert r0["dtypes"] == ["torch.float32"]  # masters stayed f32
    losses, _, _ = jax_side["bf16"]
    close(bf16[:3], losses, 2e-2, 0)


def test_3d_parallelism_dp_pp_tp(world):
    w, inputs = world
    got = w.case("tp3d")
    r0 = got[0]
    # the stacked Linear weights lie on pipe and model
    assert r0["specs"]["stacked_0_0_weight"] == ("S(0)", "S(2)")
    for r in got:
        assert r["local"]["stacked_0_0_weight"] == (1, 32, 16)
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    stage_by_stage(r0["stacked"], r0["ref"], 2, 1e-5, 1e-6)
    losses, _, _ = jax_side["tp3d"]
    losses_close(r0["losses"], losses, 1e-5)
    same_on_every_rank(got)


def test_hetero_pre_post_matches_single_device(world):
    w, inputs = world
    got = w.case("hetero")
    r0 = got[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-5)
    close(r0["pre"]["weight"], r0["ref"]["0.weight"], 1e-5, 1e-6)
    close(r0["post"]["weight"], r0["ref"]["5.weight"], 1e-5, 1e-6)
    close(r0["eval"], r0["ref_eval"], 1e-5, 1e-6)
    losses, _, _ = jax_side["hetero"]
    losses_close(r0["losses"], losses, 1e-5)
    close(r0["pre"]["weight"], jax_side["hetero_pre"], 1e-5, 1e-6)
    for r in got[1:]:  # pre and post replicated: the same values on every rank
        assert r["losses"] == r0["losses"]
        np.testing.assert_array_equal(r["pre"]["weight"], r0["pre"]["weight"])
        np.testing.assert_array_equal(r["post"]["weight"], r0["post"]["weight"])


def test_pipelined_transformer_lm_matches_single_device(world):
    w, inputs = world
    got = w.case("lm")
    r0 = got[0]
    losses_close(r0["losses"], r0["ref_losses"], 1e-4)
    losses_close(r0["losses"], jax_side["lm"], 1e-4)
    init = inputs["lm"]["state"]["tok_embed.weight"]
    assert np.abs(r0["tok"] - init).max() > 1e-5  # the embedding's gradient flowed
    same_on_every_rank(got)


class _Mesh:
    """The mesh's axis names and sizes: all the constructor's first checks
    read."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = list(axes.values())

    def size(self, k):
        return self._sizes[k]


def port_parts():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch.parallel import PipelineStack

    pre, post = tnn.Linear(8, 16, device="cpu"), tnn.Linear(16, 4, device="cpu")
    stack = PipelineStack([tnn.Sequential(tnn.Linear(16, 16, device="cpu"), tnn.ReLU())
                           for _ in range(4)])
    return pre, stack, post


def test_hetero_optimizer_order_enforced():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch import optim as toptim
    from deepflows_tpu_torch.parallel import PipelinedTrainStep

    pre, stack, post = port_parts()
    params = list(stack.parameters()) + list(pre.parameters()) + list(post.parameters())
    with pytest.raises(ValueError, match="pre.parameters"):
        PipelinedTrainStep(stack, toptim.SGD(params, lr=0.1), tnn.MSELoss(),
                           _Mesh(data=2, pipe=4), n_micro=4, pre=pre, post=post)


def test_hetero_buffered_pre_rejected():
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch import optim as toptim
    from deepflows_tpu_torch.parallel import PipelinedTrainStep

    _, stack, _ = port_parts()
    pre = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.BatchNorm1d(16, device="cpu"))
    params = list(pre.parameters()) + list(stack.parameters())
    with pytest.raises(ValueError, match="buffer-free"):
        PipelinedTrainStep(stack, toptim.SGD(params, lr=0.1), tnn.MSELoss(),
                           _Mesh(data=2, pipe=4), n_micro=4, pre=pre)


def test_constructor_refusals_match_jax():
    """The schedule, the pipe axis and the stage count are refused with the
    JAX package's messages."""
    from deepflows_tpu.parallel.pipeline import PipelinedTrainStep as JStep

    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch import optim as toptim
    from deepflows_tpu_torch.parallel import PipelinedTrainStep

    _, stack, _ = port_parts()
    jstack = jax_stack("mlp", 4)
    cases = [({"schedule": "zigzag"}, _Mesh(pipe=4), {"pipe": 4}),
             ({}, _Mesh(data=4), {"data": 4}),
             ({}, _Mesh(data=2, pipe=2), {"data": 2, "pipe": 2}),
             ({"schedule": "interleaved_1f1b"}, _Mesh(pipe=3), None)]
    for kw, mesh, jaxes in cases:
        with pytest.raises(ValueError) as mine:
            PipelinedTrainStep(stack, toptim.SGD(stack.parameters(), lr=0.1), tnn.MSELoss(),
                               mesh, 4, **kw)
        if jaxes is None:
            assert "divisible by mesh pipe=3" in str(mine.value)
            continue
        with pytest.raises(ValueError) as theirs:
            JStep(jstack, optim.SGD(jstack.parameters(), lr=0.1), nn.MSELoss(),
                  jax_mesh(jaxes), 4, **kw)
        assert str(mine.value) == str(theirs.value)


def test_rank_refusals(world):
    w, _ = world
    for r in w.case("rejections"):
        assert "unknown schedule 'zigzag'" in r["schedule"]
        assert "mesh has no axis 'pipe'" in r["no_pipe"]
        assert "mesh pipe=4 != 2 stages" in r["stages"]
        assert "PER-STAGE shape" in r["rules_rank"]
        assert "batch 8 not divisible by n_micro 3" in r["batch"]


def test_live_dropout_refused():
    """A stage holding Dropout(p > 0) is refused in training (the JAX
    package's mask there is a trace constant); p = 0 and eval mode run."""
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch import optim as toptim
    from deepflows_tpu_torch.parallel import PipelinedTrainStep, PipelineStack

    def stages(p):
        return [tnn.Sequential(tnn.Linear(8, 8, device="cpu"), tnn.Dropout(p))
                for _ in range(2)]

    stack = PipelineStack(stages(0.5))
    with pytest.raises(ValueError, match="live Dropout"):
        stack.stage_fn()
    with pytest.raises(ValueError, match="live Dropout"):
        PipelinedTrainStep(stack, toptim.SGD(stack.parameters(), lr=0.1), tnn.MSELoss(),
                           _Mesh(pipe=2), 2)
    stack.template.eval()
    assert callable(stack.stage_fn())
    assert callable(PipelineStack(stages(0.0)).stage_fn())
    bn = PipelineStack([tnn.Sequential(tnn.Linear(8, 8, device="cpu"),
                                       tnn.BatchNorm1d(8, device="cpu"), tnn.Dropout(0.1))
                        for _ in range(2)])
    with pytest.raises(ValueError, match="live Dropout"):
        bn.buffered_stage_fn(training=True)
    assert callable(bn.buffered_stage_fn(training=False))


def test_purified_call_leaves_the_module_as_it_was():
    """purified_call binds the given tensors for one call: the module's own
    parameters, buffers and mode and the package generator are as they
    were, and the new buffers come back in copies."""
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import nn as tnn
    from deepflows_tpu_torch import random as trandom
    from deepflows_tpu_torch.purify import purified_call, purify_fn

    m = tnn.Sequential(tnn.Linear(4, 4, device="cpu"), tnn.BatchNorm1d(4, device="cpu"))
    params = [p for _, p in m.named_parameters()]
    bufs = [b for _, b in m.named_buffers()]
    own = [t.detach().clone() for t in params + bufs]
    dt.manual_seed(0)
    g = trandom.generator("cpu")
    g_state = g.get_state()
    ps = [torch.randn_like(p) for p in params]
    bs = [b.detach().clone() for b in bufs]
    x = torch.randn(6, 4)
    y, nb = purified_call(m, params, bufs, ps, bs, x)
    want = torch.nn.functional.linear(x, ps[0].T, ps[1].reshape(-1))
    mean = want.mean(0)
    close(nb[0].reshape(-1).numpy(), (0.1 * mean).numpy(), 1e-5, 1e-6)  # EMA from 0
    for t, o in zip(params + bufs, own):
        assert torch.equal(t.detach(), o)
    for b, o in zip(bs, own[len(params):]):
        assert torch.equal(b, o)  # the tensors given are not written
    assert m.training and torch.equal(g.get_state(), g_state)
    f = purify_fn(lambda a, b: (a - b).abs().sum())
    assert float(f(torch.ones(3), np.zeros(3, np.float32))) == 3.0
