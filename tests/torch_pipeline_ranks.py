"""The rank side of the port's pipeline tests (``tests/test_torch_pipeline.py``
and ``tests/test_torch_pipeline_1f1b.py``).

Each rank is a process that imports torch and the port, never JAX::

    python tests/torch_pipeline_ranks.py --rank R --world 4 --store FILE \
        --inp cases.pkl --out results --cases gpipe_mlp,...

It runs as ``tests/torch_parallel_ranks.py`` does (one gloo group, a file
rendezvous, ``<out>.<rank>.pkl``), with the cases below.  Each case builds
its stages and loads the weights the test took from the JAX package's
modules (``load_jax_state_dict``), trains ``PipelinedTrainStep`` on its
mesh, and returns losses and the whole stacked weights in logical stage
order (gathered by every rank).  Unpipelined reference runs
(``CompiledTrainStep`` on the stages one after another) take place on
rank 0.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from torch_parallel_ranks import World as _World
from torch_parallel_ranks import main, rank, whole

from deepflows_tpu_torch import models, nn, optim  # noqa: E402
from deepflows_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from deepflows_tpu_torch.parallel import (  # noqa: E402
    PipelinedTrainStep, PipelineStack, make_mesh, pipeline_apply, tensor_parallel_rules)
from deepflows_tpu_torch.utils import load_jax_state_dict  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


class World(_World):
    """The 4 ranks of this file's cases, in the background."""

    def __init__(self, cases, inputs, tmpdir, n=4, timeout=240):
        super().__init__(cases, inputs, tmpdir, n, timeout, script=os.path.abspath(__file__))


# ------------------------------------------------------------------ the stages
class L2Stage(nn.Module):
    """A Linear whose output rows are L2-normalised (0/0 at x = 0)."""

    def __init__(self, width):
        super().__init__()
        self.lin = nn.Linear(width, width, device="cpu")

    def forward(self, x):
        y = self.lin(x)
        return y / (y * y).sum(1, True).sqrt()


def stage(kind, width=16, ch=4, **kw):
    """One stage of a kind; the JAX tests' stages."""
    if kind == "mlp":
        return nn.Sequential(nn.Linear(width, width, device="cpu"), nn.ReLU())
    if kind == "pair":  # two mlp stages as one
        return nn.Sequential(nn.Linear(width, width, device="cpu"), nn.ReLU(),
                             nn.Linear(width, width, device="cpu"), nn.ReLU())
    if kind == "conv_bn":
        return nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1, bias=False, device="cpu"),
                             nn.BatchNorm2d(ch, device="cpu"), nn.ReLU())
    if kind == "lin_bn":
        return nn.Sequential(nn.Linear(width, width, device="cpu"),
                             nn.BatchNorm1d(width, device="cpu"), nn.ReLU())
    if kind == "l2":
        return L2Stage(width)
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


def unstack(stack, state):
    """A JAX stack's state as ``{"s.name": row s}`` of its stages run one
    after another (``nn.Sequential(*stages)``)."""
    out = {}
    for names, kind in ((stack._param_names, "p"), (stack._buffer_names, "b")):
        for i, name in enumerate(names):
            arr = state[f"stacked_{i}_{name.replace('.', '_')}"]
            for s in range(arr.shape[0]):
                out[f"{s}.{name}"] = arr[s]
    return out


def build_stack(inp, kind=None, n=None):
    """The case's stages stacked and loaded with the JAX stack's state."""
    kind = kind or inp["stage"]
    n = n or inp["S"]
    kw = inp.get("stage_kw", {})
    stack = PipelineStack([stage(kind, **kw) for _ in range(n)])
    load_jax_state_dict(stack, inp["state"])
    return stack


def ref_model(inp, stack):
    """The stages one after another, with the same weights (and pre and post
    around them)."""
    kw = inp.get("stage_kw", {})
    S = stack.n_stages
    mods = [stage(inp["stage"], **kw) for _ in range(S)]
    seq = nn.Sequential(*mods)
    load_jax_state_dict(seq, unstack(stack, inp["state"]))
    if "pre" not in inp:
        return seq
    pre, post = build_pre_post(inp)
    return nn.Sequential(pre, *mods, post)


def build_pre_post(inp):
    kind = inp["pre_post"]
    if kind == "linear":
        pre, post = nn.Linear(8, 16, device="cpu"), nn.Linear(16, 4, device="cpu")
    else:  # embedding -> chunks -> head
        pre = nn.Embedding(inp["vocab"], inp["width"], device="cpu")
        post = nn.Linear(inp["width"], inp["vocab"], device="cpu")
    load_jax_state_dict(pre, inp["pre"])
    load_jax_state_dict(post, inp["post"])
    return pre, post


OPTS = {
    "sgd": lambda ps: optim.SGD(ps, lr=0.1, momentum=0.9),
    "sgd01": lambda ps: optim.SGD(ps, lr=0.1),
    "sgd05": lambda ps: optim.SGD(ps, lr=0.05),
    "sgd05m": lambda ps: optim.SGD(ps, lr=0.05, momentum=0.9),
    "adam": lambda ps: optim.Adam(ps, lr=1e-3),
    "adam2": lambda ps: optim.Adam(ps, lr=1e-2),
}


def crit_of(name):
    return nn.CrossEntropyLoss() if name == "ce" else nn.MSELoss()


def tensor(a):
    a = torch.from_numpy(np.asarray(a))
    return a.long() if a.dtype in (torch.int32, torch.int64) else a


def logical(step, stack):
    """Every stacked parameter whole, in logical stage order."""
    out = [whole(p) for p in stack.parameters()]
    if step._stage_inv is not None:
        out = [a[step._stage_inv] for a in out]
    return out


def logical_buffers(step, stack):
    out = [whole(b) for _, b in stack.named_buffers()]
    if step._stage_inv is not None:
        out = [a[step._stage_inv] for a in out]
    return out


def pipelined(inp, axes, schedule="gpipe", M=None, stack=None, **kw):
    """Train the case's stack (and pre / post) by PipelinedTrainStep over
    ``axes``; returns (step, stack, pre, post, losses)."""
    mesh = make_mesh(axes)
    stack = stack or build_stack(inp)
    pre = post = None
    params = list(stack.parameters())
    if "pre" in inp:
        pre, post = build_pre_post(inp)
        params = list(pre.parameters()) + params + list(post.parameters())
    opt = OPTS[inp["opt"]](params)
    if inp.get("bf16"):
        kw["compute_dtype"] = torch.bfloat16
    step = PipelinedTrainStep(stack, opt, crit_of(inp.get("crit")), mesh,
                              n_micro=M or inp["M"], pre=pre, post=post, schedule=schedule, **kw)
    losses = [float(step(tensor(x), tensor(y))) for x, y in inp["batches"]]
    return step, stack, pre, post, losses


def reference(inp, accum=1):
    """Rank 0: the unpipelined run of the case (losses, per-stage weights)."""
    stack = build_stack(inp)
    m = ref_model(inp, stack)
    opt = OPTS[inp["opt"]](m.parameters())
    kw = {"compute_dtype": torch.bfloat16} if inp.get("bf16") else {}
    step = CompiledTrainStep(m, opt, crit_of(inp.get("crit")), accum_steps=accum, **kw)
    losses = [float(step(tensor(x), tensor(y))) for x, y in inp["batches"]]
    return m, losses


def specs(stack):
    from torch.distributed.tensor import DTensor

    return {n: tuple(str(pl) for pl in p.placements) if isinstance(p, DTensor) else None
            for n, p in stack.named_parameters()}


def trained(inp, axes, schedule="gpipe", accum=None, eval_x=None, **kw):
    """A pipelined run's numbers, with the reference's on rank 0."""
    step, stack, pre, post, losses = pipelined(inp, axes, schedule, **kw)
    out = {"losses": losses, "stacked": logical(step, stack),
           "buffers": logical_buffers(step, stack), "specs": specs(stack),
           "local": {n: tuple(p.to_local().shape) for n, p in stack.named_parameters()},
           "master_dtypes": sorted({str(p.dtype) for p in step._params})}
    if pre is not None:
        out["pre"] = {n: whole(p) for n, p in pre.named_parameters()}
        out["post"] = {n: whole(p) for n, p in post.named_parameters()}
    if eval_x is not None:
        before = logical_buffers(step, stack)
        out["eval"] = step.eval_logits(tensor(eval_x)).numpy()
        out["eval_kept_buffers"] = all(np.array_equal(a, b) for a, b in
                                       zip(before, logical_buffers(step, stack)))
    if rank() == 0 and accum is not None:
        m, ref_losses = reference(inp, accum)
        out["ref_losses"] = ref_losses
        out["ref"] = {n: whole(p) for n, p in m.named_parameters()}
        out["ref_buffers"] = {n: whole(b) for n, b in m.named_buffers()}
        if eval_x is not None:
            m.eval()
            with torch.no_grad():
                out["ref_eval"] = m(tensor(eval_x)).numpy()
    return out


# ------------------------------------------------------------------ the GPipe file's cases
@case
def apply_mesh(inp):
    """pipeline_apply over {data: 2, pipe: 2} (two stages a rank) against
    the plain version, buffer-free and with BatchNorm stages."""
    out = {}
    for key in ("mlp", "bn"):
        c = inp[key]
        stack = build_stack(c)
        x = torch.from_numpy(c["x"])
        stacked = list(stack.parameters())
        bufs = [b for _, b in stack.named_buffers()] or None
        fn = stack.buffered_stage_fn() if bufs else stack.stage_fn()
        got = pipeline_apply(fn, stacked, x, stacked_buffers=bufs,
                             mesh=make_mesh({"data": 2, "pipe": 2}))
        with torch.no_grad():
            want = pipeline_apply(fn, stacked, x, stacked_buffers=bufs)
        if bufs:
            out[key] = dict(out=got[0].detach().numpy(), want=want[0].numpy(),
                            bufs=[b.numpy() for b in got[1]], want_bufs=[b.numpy()
                                                                         for b in want[1]])
        else:
            out[key] = dict(out=got.detach().numpy(), want=want.numpy())
    return out


@case
def gpipe_mlp(inp):
    return trained(inp, {"pipe": 4}, accum=1, eval_x=inp["eval_x"])


@case
def gpipe_bn(inp):
    return trained(inp, {"data": 2, "pipe": 2}, accum=inp["M"], eval_x=inp["eval_x"])


@case
def bubble(inp):
    return trained(inp, {"pipe": 4})


@case
def fuzz(inp):
    out = {}
    for seed, c in inp.items():
        S = c["S"]
        out[seed] = trained(c, {"data": 4 // S, "pipe": S}, accum=c["M"])
    return out


@case
def bf16(inp):
    f32 = trained(dict(inp, bf16=False), {"pipe": 4})
    b16 = trained(inp, {"pipe": 4})
    return {"f32": f32["losses"], "bf16": b16["losses"], "dtypes": b16["master_dtypes"]}


@case
def tp3d(inp):
    return trained(inp, {"pipe": 2, "model": 2}, accum=1,
                   param_rules=tensor_parallel_rules("model"))


@case
def hetero(inp):
    return trained(inp, {"pipe": 4}, accum=1, eval_x=inp["eval_x"])


@case
def lm(inp):
    """TransformerLM split by pipeline_partition over {data: 2, pipe: 2}."""
    def build():
        m = models.TransformerLM(**inp["cfg"], device="cpu", flash=False)
        load_jax_state_dict(m, inp["state"])
        return m

    lm_ = build()
    pre, blocks, post = lm_.pipeline_partition()
    stack = PipelineStack(blocks)
    params = list(pre.parameters()) + list(stack.parameters()) + list(post.parameters())
    step = PipelinedTrainStep(stack, optim.Adam(params, lr=1e-3), nn.CrossEntropyLoss(),
                              make_mesh({"data": 2, "pipe": 2}), n_micro=inp["M"], pre=pre,
                              post=post)
    losses = [float(step(tensor(x), tensor(y))) for x, y in inp["batches"]]
    out = {"losses": losses, "stacked": logical(step, stack),
           "tok": whole(dict(pre.named_parameters())["tok_embed.weight"])}
    if rank() == 0:
        ref = build()
        s0 = CompiledTrainStep(ref, optim.Adam(ref.parameters(), lr=1e-3),
                               nn.CrossEntropyLoss())
        out["ref_losses"] = [float(s0(tensor(x), tensor(y))) for x, y in inp["batches"]]
    return out


@case
def ckpt(inp):
    """Checkpoints of a pipe-sharded stack: the port's own round trip, a JAX
    file into the placed stack and optimizer, the port's file for the JAX
    package, an interleaved layout's file, load_jax_state_dict into the
    blocks."""
    from deepflows_tpu_torch.utils.model_utils import load_checkpoint, save_checkpoint

    out = {}
    # the port's round trip (the JAX test's)
    step, stack, _, _, _ = pipelined(inp, {"pipe": 4})
    save_checkpoint(stack, step.optimizer, epoch=1, save_path=inp["port_path"])
    torch.distributed.barrier()  # rank 0 has written it
    stack2 = PipelineStack([stage("mlp") for _ in range(4)])  # another init
    opt2 = OPTS[inp["opt"]](stack2.parameters())
    load_checkpoint(stack2, opt2, load_path=inp["port_path"])
    out["reloaded"] = [whole(p) for p in stack2.parameters()]
    out["saved"] = [whole(p) for p in stack.parameters()]
    step2 = PipelinedTrainStep(stack2, opt2, nn.MSELoss(), make_mesh({"pipe": 4}), n_micro=4)
    x2, y2 = inp["next"]
    out["next"] = [float(step(tensor(x2), tensor(y2))), float(step2(tensor(x2), tensor(y2)))]
    # the JAX package's file into a placed stack and optimizer, then on
    stack3 = build_stack(dict(inp, state=inp["init_state"]))
    opt3 = OPTS[inp["opt"]](stack3.parameters())
    step3 = PipelinedTrainStep(stack3, opt3, nn.MSELoss(), make_mesh({"pipe": 4}), n_micro=4)
    load_checkpoint(stack3, opt3, load_path=inp["jax_path"])
    out["from_jax"] = [whole(p) for p in stack3.parameters()]
    out["from_jax_v"] = [whole(v) for v in opt3._state["v"]]
    out["from_jax_blocks"] = [tuple(p.to_local().shape) for p in stack3.parameters()]
    out["from_jax_next"] = float(step3(tensor(x2), tensor(y2)))
    # load_jax_state_dict into the blocks
    load_jax_state_dict(stack3, inp["init_state"])
    out["blocks"] = [p.to_local().detach().numpy() for p in stack3.parameters()]
    # an interleaved layout saved before any step: the permuted stacking
    stack4 = build_stack(dict(inp, state=inp["il_state"], S=8))
    opt4 = OPTS[inp["opt"]](stack4.parameters())
    PipelinedTrainStep(stack4, opt4, nn.MSELoss(), make_mesh({"pipe": 4}), n_micro=4,
                       schedule="interleaved_1f1b")
    save_checkpoint(stack4, opt4, save_path=inp["il_path"])
    return out


@case
def rejections(inp):
    """The constructor's refusals that need a mesh of ranks."""
    out = {}
    mesh = make_mesh({"data": 1, "pipe": 4})
    stack = PipelineStack([stage("mlp") for _ in range(4)])
    tries = {
        "schedule": lambda: PipelinedTrainStep(stack, optim.SGD(stack.parameters(), lr=0.1),
                                               nn.MSELoss(), mesh, 4, schedule="zigzag"),
        "no_pipe": lambda: PipelinedTrainStep(stack, optim.SGD(stack.parameters(), lr=0.1),
                                              nn.MSELoss(), make_mesh({"data": 4}), 4),
        "stages": lambda: PipelinedTrainStep(
            PipelineStack([stage("mlp") for _ in range(2)]), optim.SGD(
                stack.parameters(), lr=0.1), nn.MSELoss(), mesh, 4),
        "rules_rank": lambda: PipelinedTrainStep(
            stack, optim.SGD(stack.parameters(), lr=0.1), nn.MSELoss(), mesh, 4,
            param_rules=lambda n, s: (None,) * (len(s) + 1)),
        "batch": lambda: PipelinedTrainStep(stack, optim.SGD(stack.parameters(), lr=0.1),
                                            nn.MSELoss(), mesh, 3)(
            torch.zeros(8, 16), torch.zeros(8, 16)),
    }
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------------------ the 1F1B file's cases
@case
def f1b_single(inp):
    return trained(inp, {"pipe": 4}, "1f1b", accum=1)


@case
def f1b_vs_gpipe(inp):
    out = {}
    for M in inp["n_micro"]:
        out[M] = {s: trained(inp, {"pipe": 4}, s, M=M) for s in ("gpipe", "1f1b")}
    return out


@case
def f1b_hetero(inp):
    return trained(inp, {"pipe": 4}, "1f1b", accum=1)


@case
def f1b_bn(inp):
    return {s: trained(inp, {"data": 2, "pipe": 2}, s) for s in ("gpipe", "1f1b")}


@case
def f1b_bf16(inp):
    return {s: trained(inp, {"pipe": 4}, s) for s in ("gpipe", "1f1b")}


@case
def bubbles(inp):
    mesh = make_mesh({"pipe": 4})
    out = {}
    for name, n, sched in (("1f1b", 4, "1f1b"), ("interleaved", 8, "interleaved_1f1b"),
                           ("gpipe", 4, "gpipe")):
        stack = PipelineStack([stage("mlp") for _ in range(n)])
        step = PipelinedTrainStep(stack, optim.SGD(stack.parameters(), lr=0.1), nn.MSELoss(),
                                  mesh, n_micro=12, schedule=sched)
        out[name] = (step.bubble_fraction, getattr(step, "virtual_stages", None))
    return out


class _Saved:
    """Bytes saved for backward now and at the peak, by pack hooks."""

    def __init__(self):
        self.now = self.peak = 0

    def hooks(self):
        counter = self

        class Held:
            __slots__ = ("t", "n")

            def __init__(self, t):
                self.t, self.n = t, t.numel() * t.element_size()
                counter.now += self.n
                counter.peak = max(counter.peak, counter.now)

            def __del__(self):
                counter.now -= self.n

        return torch.autograd.graph.saved_tensors_hooks(Held, lambda h: h.t)


@case
def memory(inp):
    """Peak bytes saved for backward on this rank during one step, by
    schedule and M, and the bytes one stage's forward of one microbatch
    saves."""
    out = {}
    rows, width = inp["rows"], inp["width"]
    for sched, n in (("gpipe", 4), ("1f1b", 4), ("interleaved_1f1b", 8)):
        for M in (4, 32):
            stack = PipelineStack([stage("mlp", width=width) for _ in range(n)])
            step = PipelinedTrainStep(stack, optim.SGD(stack.parameters(), lr=0.1),
                                      nn.MSELoss(), make_mesh({"pipe": 4}), n_micro=M,
                                      schedule=sched)
            x = torch.randn(M * rows, width)
            saved = _Saved()
            with saved.hooks():
                step(x, x)
            out[(sched, M)] = saved.peak
    stack = PipelineStack([stage("mlp", width=width)])
    fn = stack.stage_fn()
    ps = [p.detach().clone().requires_grad_() for p in stack.parameters()]
    saved = _Saved()
    with saved.hooks():
        y = fn([p[0] for p in ps], torch.randn(rows, width, requires_grad=True))
        out["unit"] = saved.now
    del y
    return out


@case
def il_vs_gpipe(inp):
    """Interleaved 1F1B of 8 stages on {pipe: 4} against GPipe of the same
    8 blocks as 4 stages of two."""
    out = {}
    for M in inp["n_micro"]:
        c = dict(inp, batches=inp["batches_by_m"][M])
        il = trained(c, {"pipe": 4}, "interleaved_1f1b", M=M)
        pairs = build_stack(dict(c, state=inp["pair_state"]), "pair", 4)
        gp = trained(dict(c, stage="pair"), {"pipe": 4}, "gpipe", M=M, stack=pairs)
        out[M] = {"interleaved": il, "gpipe": gp}
    return out


@case
def il_single(inp):
    return trained(inp, {"pipe": 4}, "interleaved_1f1b", accum=1, eval_x=inp["eval_x"])


@case
def il_bn(inp):
    return {"gpipe": trained(inp, {"pipe": 4}, "gpipe"),
            "interleaved_1f1b": trained(inp, {"data": 2, "pipe": 2}, "interleaved_1f1b")}


@case
def il_hetero(inp):
    return trained(inp, {"pipe": 4}, "interleaved_1f1b", accum=1)


@case
def il_bf16(inp):
    il = trained(inp, {"pipe": 4}, "interleaved_1f1b")
    pairs = build_stack(dict(inp, state=inp["pair_state"]), "pair", 4)
    gp = trained(dict(inp, stage="pair"), {"pipe": 4}, "gpipe", stack=pairs)
    return {"interleaved": il, "gpipe": gp}


@case
def il_relayout(inp):
    """Steps rebuilt over one live stack: a second interleaved step keeps
    the layout, a GPipe step restores logical order."""
    stack = build_stack(inp)
    opt = OPTS[inp["opt"]](stack.parameters())
    first = PipelinedTrainStep(stack, opt, nn.MSELoss(), make_mesh({"data": 2, "pipe": 2}),
                               n_micro=4, schedule="interleaved_1f1b")
    after_first = [whole(p) for p in stack.parameters()]
    PipelinedTrainStep(stack, opt, nn.MSELoss(), make_mesh({"data": 2, "pipe": 2}), n_micro=4,
                       schedule="interleaved_1f1b")
    after_second = [whole(p) for p in stack.parameters()]
    slots_second = [whole(v) for v in opt._state["v"]] if "v" in opt._state else None
    PipelinedTrainStep(stack, opt, nn.MSELoss(), make_mesh({"pipe": 4}), n_micro=4)
    return {"perm": first._stage_perm, "first": after_first, "second": after_second,
            "slots": slots_second, "restored": [whole(p) for p in stack.parameters()],
            "layout": getattr(stack, "_stage_layout_perm", None)}


if __name__ == "__main__":
    main(CASES)
