"""The rank side of the port's mesh-parallel tests
(``tests/test_torch_parallel.py``, ``test_torch_parallel_ckpt.py`` and
``test_torch_ring_attention.py``).

Each rank is a process that imports torch and the port, never JAX::

    python tests/torch_parallel_ranks.py --rank R --world 4 --store FILE \
        --inp cases.pkl --out results --cases dp,tp,...

Every rank joins one gloo group (its rendezvous a file, so no port is
chosen ahead), runs the named cases in order (each
builds its meshes and models from the weights and batches in ``--inp``,
written by the test from the JAX package's models) and writes its results
to ``<out>.<rank>.pkl``: numpy arrays and Python values, with the whole
values of sharded tensors (gathered by every rank) and this rank's block
sizes.  A case that raises records its traceback and ends the process, so
the test reports it instead of waiting.  Unsharded reference runs take
place on rank 0.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from deepflows_tpu_torch import models, nn, optim  # noqa: E402
from deepflows_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from deepflows_tpu_torch.parallel import (  # noqa: E402
    ShardedEvalStep, ShardedTrainStep, expert_parallel_rules, fsdp_rules, make_mesh,
    ring_attention, sequence_sharding, tensor_parallel_rules)
from deepflows_tpu_torch import _data_axis  # noqa: E402
from deepflows_tpu_torch.utils import load_jax_state_dict  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def rank():
    return dist.get_rank()


# ------------------------------------------------------------------ helpers
def make_model():
    return nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1, bias=False, device="cpu"),
        nn.BatchNorm2d(8, device="cpu"),
        nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Flatten(),
        nn.Linear(8 * 8 * 8, 32, device="cpu"),
        nn.ReLU(),
        nn.Linear(32, 4, device="cpu"),
    )


def build(kind, **kw):
    if kind == "cnn":
        return make_model()
    if kind == "mlp":
        return nn.Sequential(nn.Flatten(), nn.Linear(48, 32, device="cpu"), nn.ReLU(),
                             nn.Linear(32, 4, device="cpu"))
    if kind == "dropout":
        return nn.Sequential(nn.Flatten(), nn.Linear(48, 32, device="cpu"), nn.ReLU(),
                             nn.Dropout(0.5), nn.Linear(32, 4, device="cpu"))
    if kind == "encoder":
        blocks = [models.EncoderBlock(32, 2, device="cpu") for _ in range(2)]
        mods = []
        for b in blocks:
            if kw.get("sp") is not None:
                mods.append(kw["sp"])
            mods.append(b)
        if kw.get("sp") is not None:
            mods.append(kw["sp"])
        return nn.Sequential(*mods)
    if kind == "moe":
        return nn.Sequential(nn.MoE(8, 16, n_experts=4, device="cpu"),
                             nn.LayerNorm(8, device="cpu"), nn.Flatten(),
                             nn.Linear(5 * 8, 3, device="cpu"))
    if kind == "switch":
        return nn.Sequential(nn.MoE(8, 32, n_experts=4, capacity_factor=1.0, device="cpu"),
                             nn.Flatten(), nn.Linear(4 * 8, 4, device="cpu"))
    if kind == "mixtral":
        return models.MixtralLM(vocab_size=24, max_len=8, dim=32, depth=1, num_heads=4,
                                num_kv_heads=2, n_experts=4, top_k=2, device="cpu",
                                flash=False)
    if kind == "resnet":
        return models.ResNet18(num_classes=4, small_input=True, device="cpu",
                               remat=kw.get("remat", False))
    if kind == "lm":
        return models.TransformerLM(vocab_size=16, max_len=32, dim=32, depth=2, num_heads=2,
                                    device="cpu", flash=False, ring=kw.get("ring"))
    raise ValueError(kind)


def loaded(kind, state, dtype=None, **kw):
    m = build(kind, **kw)
    load_jax_state_dict(m, state)
    if dtype is not None:
        m.to_dtype(dtype)
    return m


def whole(t):
    """A tensor's whole value as numpy (a DTensor is gathered: every rank
    calls this)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def params_of(m):
    return {n: whole(p) for n, p in m.named_parameters()}


def local_sizes(m):
    from torch.distributed.tensor import DTensor

    return {n: (p.to_local().numel() if isinstance(p, DTensor) else p.numel(), p.numel())
            for n, p in m.named_parameters()}


def slot_sizes(opt, key):
    from torch.distributed.tensor import DTensor

    return [None if v is None else
            (v.to_local().numel() if isinstance(v, DTensor) else v.numel(), v.numel())
            for v in opt._state[key]]


def specs_of(m):
    from torch.distributed.tensor import DTensor

    return {n: tuple(str(pl) for pl in p.placements) if isinstance(p, DTensor) else None
            for n, p in m.named_parameters()}


OPTS = {
    "sgd": lambda m: optim.SGD(m.parameters(), lr=0.05, momentum=0.9),
    "adam": lambda m: optim.Adam(m.parameters(), lr=1e-3),
    "adam01": lambda m: optim.Adam(m.parameters(), lr=0.01),
    "adam5e3": lambda m: optim.Adam(m.parameters(), lr=5e-3),
    "muon": lambda m: optim.Muon(m.parameters(), lr=0.02, adamw_lr=1e-3),
    "adafactor": lambda m: optim.Adafactor(m.parameters(), lr=1e-2),
    "adam_sr": lambda m: optim.Adam(m.parameters(), lr=1e-3, stochastic_round=True),
}


def criterion(name, m):
    if name == "ce":
        return nn.CrossEntropyLoss()
    if name == "ce_ignore":
        return nn.CrossEntropyLoss(ignore_index=-100)
    if name == "mse":
        return nn.MSELoss()
    if name == "moe_ce":
        return nn.MoECriterion(nn.CrossEntropyLoss(), m)
    raise ValueError(name)


def rules_of(name, mesh):
    return {
        None: lambda: None,
        "tp": lambda: tensor_parallel_rules("model"),
        "fsdp": lambda: fsdp_rules(mesh),
        "fsdp_tp": lambda: fsdp_rules(mesh, base=tensor_parallel_rules("model")),
        "fsdp_model": lambda: fsdp_rules(mesh, axis="model"),
        "ep": lambda: expert_parallel_rules("model"),
    }[name]()


def train(inp, mesh=None, rules=None, steps=None, **kw):
    """Train the case's model; returns (model, optimizer, step, losses)."""
    dtype = torch.bfloat16 if inp.get("bf16_params") else None
    m = loaded(inp["model"], inp["state"], dtype)
    opt = OPTS[inp["opt"]](m)
    crit = criterion(inp.get("crit", "ce"), m)
    kw = dict(kw)
    if inp.get("clip"):
        kw["grad_transform"] = optim.clip_by_global_norm(inp["clip"])
    if inp.get("bf16"):
        kw["compute_dtype"] = torch.bfloat16
    if inp.get("accum"):
        kw["accum_steps"] = inp["accum"]
    if inp.get("metrics"):
        kw["metrics_fn"] = lambda out, y: {"acc": (out.argmax(1) == y).float().mean()}
    if mesh is None:
        step = CompiledTrainStep(m, opt, crit, **kw)
    else:
        step = ShardedTrainStep(m, opt, crit, mesh, param_rules=rules_of(rules, mesh), **kw)
    batches = inp["batches"] if steps is None else inp["batches"][:steps]
    if inp.get("mask_seed") is not None:  # the dropout masks start from one state
        import deepflows_tpu_torch

        deepflows_tpu_torch.manual_seed(inp["mask_seed"])
    xdt = torch.bfloat16 if dtype is not None else None
    losses = [float(step(torch.from_numpy(x).to(xdt), torch.from_numpy(y).long()))
              for x, y in batches]
    return m, opt, step, losses


def sharded_and_plain(inp, axes, rules=None, **kw):
    """The case's sharded run (every rank) and its unsharded run (rank 0)."""
    mesh = make_mesh(axes)
    m, opt, step, losses = train(inp, mesh, rules, **kw)
    out = {"losses": losses, "params": params_of(m), "sizes": local_sizes(m),
           "specs": specs_of(m), "mesh": dict(axes), "metrics": metrics_of(step)}
    if rank() == 0:
        m0, _, s0, l0 = train(inp)
        out["ref_losses"], out["ref_params"] = l0, params_of(m0)
        out["ref_metrics"] = metrics_of(s0)
    return out, m, opt


def metrics_of(step):
    got = step._last_metrics
    return None if got is None else {k: float(v) for k, v in got.items()}


def same_on_all_ranks(t):
    """The largest difference between this tensor and rank 0's."""
    t = t.detach().float().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return max(float((p - parts[0]).abs().max()) for p in parts)


# -------------------------------------------------------------------- cases
@case
def mesh(inp):
    from deepflows_tpu_torch.parallel import auto_mesh

    m = make_mesh({"data": 2, "model": 2})
    a = auto_mesh(4, model_parallel=2)
    try:
        make_mesh({"data": 8})
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    return {"names": tuple(m.mesh_dim_names), "shape": tuple(m.shape),
            "auto": (a.size(0), a.size(1)), "mismatch": mismatch,
            "jax_modules": sorted(k for k in sys.modules
                                  if k.split(".")[0] in ("jax", "jaxlib", "deepflows_tpu"))}


@case
def dp(inp):
    out, m, _ = sharded_and_plain(inp, {"data": 4})
    out["bn_spread"] = same_on_all_ranks(m[1].running_var)
    return out


@case
def tp(inp):
    out, m, _ = sharded_and_plain(inp, {"data": 2, "model": 2}, "tp")
    out["local_shapes"] = {"5.weight": tuple(m[5].weight.to_local().shape),
                           "0.weight": tuple(m[0].weight.to_local().shape)}
    out["bn_spread"] = same_on_all_ranks(m[1].running_mean)
    out["bn_mean"] = whole(m[1].running_mean)
    return out


@case
def eval_step(inp):
    """ShardedEvalStep over {data: 4}, and with tensor_parallel_rules over
    {data: 2, model: 2} (the weights placed by the rule)."""
    x = torch.from_numpy(inp["x"])
    m2 = loaded("cnn", inp["state"])
    m2.eval()
    with torch.no_grad():
        want = m2(x).numpy()
    m = loaded("cnn", inp["state"])
    out = ShardedEvalStep(m, make_mesh({"data": 4}))(x).numpy()
    mt = loaded("cnn", inp["state"])
    ev = ShardedEvalStep(mt, make_mesh({"data": 2, "model": 2}),
                         param_rules=tensor_parallel_rules("model"))
    return {"out": out, "ref": want, "tp_out": ev(x).numpy(), "tp_specs": specs_of(mt),
            "training": mt.training}


@case
def bf16(inp):
    out, m, _ = sharded_and_plain(inp, {"data": 4})
    out["dtype"] = str(m[0].weight.dtype)
    return out


@case
def accum(inp):
    out, _, _ = sharded_and_plain(inp, {"data": 2, "model": 2}, "tp")
    return out


@case
def zero(inp):
    out, _, opt = sharded_and_plain(inp, {"data": 4}, zero_shard_state=True)
    out["v_sizes"] = slot_sizes(opt, "v")
    out["v_specs"] = [None if v is None else tuple(str(p) for p in v.placements)
                      for v in opt._state["v"]]
    mesh = make_mesh({"data": 4})
    m1, _, _, l1 = train(inp, mesh)
    out["replicated_losses"], out["replicated_params"] = l1, params_of(m1)
    return out


@case
def fsdp(inp):
    out, m, opt = sharded_and_plain(inp, {"data": 4}, "fsdp")
    out["v_sizes"] = slot_sizes(opt, "v")
    mesh = make_mesh({"data": 4})
    m1, _, _, l1 = train(inp, mesh)
    out["replicated_losses"], out["replicated_params"] = l1, params_of(m1)
    return out


@case
def fsdp_tp(inp):
    out, m, _ = sharded_and_plain(inp, {"data": 2, "model": 2}, "fsdp_tp")
    mesh = make_mesh({"data": 2, "model": 2})
    _, _, _, l1 = train(inp, mesh, "tp")
    out["tp_losses"] = l1
    return out


@case
def fsdp_muon(inp):
    out, _, opt = sharded_and_plain(inp, {"data": 4}, "fsdp")
    out["m_sizes"] = slot_sizes(opt, "m")
    return out


@case
def fsdp_clip(inp):
    out, _, _ = sharded_and_plain(inp, {"data": 4}, "fsdp")
    return out


@case
def fsdp_adafactor(inp):
    out, _, opt = sharded_and_plain(inp, {"data": 4}, "fsdp")
    out["row_sizes"] = slot_sizes(opt, "row")
    return out


@case
def fsdp_sr(inp):
    out, m, _ = sharded_and_plain(inp, {"model": 4}, "fsdp_model")
    out["dtype"] = str(m[5].weight.dtype)
    return out


@case
def remat_resnet(inp):
    mesh = make_mesh({"data": 4})
    m = loaded("resnet", inp["state"], remat=True)
    opt = optim.SGD(m.parameters(), lr=0.05, momentum=0.9)
    step = ShardedTrainStep(m, opt, nn.CrossEntropyLoss(), mesh)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y).long()))
              for x, y in inp["batches"]]
    out = {"losses": losses}
    if rank() == 0:
        m0 = loaded("resnet", inp["state"])
        opt0 = optim.SGD(m0.parameters(), lr=0.05, momentum=0.9)
        s0 = CompiledTrainStep(m0, opt0, nn.CrossEntropyLoss())
        out["ref_losses"] = [float(s0(torch.from_numpy(x), torch.from_numpy(y).long()))
                             for x, y in inp["batches"]]
    return out


@case
def seq(inp):
    mesh = make_mesh({"data": 2, "model": 2})
    res = {}
    for with_sp in (False, True):
        sp = sequence_sharding(mesh, axis="model", dim=1) if with_sp else None
        m = loaded("encoder", inp["state_sp" if with_sp else "state"], sp=sp)
        opt = optim.Adam(m.parameters(), lr=1e-3)
        step = ShardedTrainStep(m, opt, nn.MSELoss(), mesh)
        res[with_sp] = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
                        for x, y in inp["batches"]]
    return {"plain": res[False], "sp": res[True]}


@case
def ep_moe(inp):
    out, m, _ = sharded_and_plain(inp, {"data": 2, "model": 2}, "ep")
    mesh = make_mesh({"data": 2, "model": 2})
    _, _, _, l1 = train(inp, mesh)
    out["replicated_losses"] = l1
    return out


@case
def ep_switch(inp):
    """Switch (capacity) MoE under EP on {data: 2, model: 2}: capacity and
    token order count the global batch."""
    out, m, _ = sharded_and_plain(inp, {"data": 2, "model": 2}, "ep")
    out["dropped"] = float(m[0].last_dropped_fraction)
    return out


@case
def seq_dtensor(inp):
    """A ShardConstraint is the identity on a plain tensor and refuses a
    DTensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_mesh({"data": 2, "model": 2})
    sp = sequence_sharding(mesh, axis="model", dim=1)
    full = torch.from_numpy(inp["x"])
    x = distribute_tensor(full, mesh, [Shard(0), Replicate()])
    return {"refused": refusal(lambda: sp(x)), "plain_is_identity": sp(full) is full,
            "repr": repr(sp)}


def refusal(fn):
    """The message of the TypeError ``fn()`` raises (None if it returns)."""
    try:
        fn()
    except TypeError as e:
        return str(e)
    return None


@case
def dropout(inp):
    """Live dropout under DP over {data: 4} and over {data: 2, model: 2}:
    the masks are the unsharded step's."""
    out, _, _ = sharded_and_plain(inp, {"data": 4})
    mesh = make_mesh({"data": 2, "model": 2})
    m1, _, _, l1 = train(inp, mesh, "tp")
    out["tp_losses"], out["tp_params"] = l1, params_of(m1)
    if rank() == 0:  # the same steps without dropout: it was live
        m2 = loaded("dropout", inp["state"])
        m2[3].p = 0.0
        s2 = CompiledTrainStep(m2, OPTS[inp["opt"]](m2), nn.CrossEntropyLoss())
        out["no_dropout_losses"] = [float(s2(torch.from_numpy(x), torch.from_numpy(y).long()))
                                    for x, y in inp["batches"]]
    return out


@case
def sft(inp):
    """A mean cross-entropy over the positions ignore_index keeps (SFT
    prompt masking, an uneven count per rank) on {data: 4}."""
    out, _, _ = sharded_and_plain(inp, {"data": 4})
    return out


@case
def ep_mixtral(inp):
    out, m, _ = sharded_and_plain(inp, {"data": 2, "model": 2}, "ep")
    moe = m.blocks[0].moe
    out["fraction"] = moe.last_expert_fraction.numpy()
    return out


@case
def bn_functional(inp):
    """F.batch_norm on each rank's rows inside the data axis's scope gives
    the global batch's output rows and statistics."""
    from deepflows_tpu_torch.nn import functional as F

    mesh = make_mesh({"data": 4})
    x = torch.from_numpy(inp["x"])
    w, b = torch.from_numpy(inp["w"]), torch.from_numpy(inp["b"])
    d = mesh.get_local_rank("data")
    xl = x.chunk(4)[d].clone().requires_grad_(True)
    with _data_axis.scope(mesh.get_group("data"), 4, d):
        out, mean, var = F.batch_norm(xl, w, b)
        (out * torch.from_numpy(inp["g"]).chunk(4)[d]).sum().backward()
    parts = [torch.empty_like(xl) for _ in range(4)]
    dist.all_gather(parts, xl.grad)
    res = {"out": whole_rows(out), "mean": mean.detach().numpy(), "var": var.detach().numpy(),
           "dx": torch.cat(parts).numpy()}
    xf = x.clone().requires_grad_(True)
    o, mf, vf = F.batch_norm(xf, w, b)
    (o * torch.from_numpy(inp["g"])).sum().backward()
    res.update(ref_out=o.detach().numpy(), ref_mean=mf.numpy(), ref_var=vf.numpy(),
               ref_dx=xf.grad.numpy())
    return res


def whole_rows(t):
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()


@case
def dtensor_kernels(inp):
    """A DTensor at each training kernel's entry raises, on every rank."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from deepflows_tpu_torch import ops

    mesh = make_mesh({"data": 4})
    q = distribute_tensor(torch.randn(4, 2, 8, 4), mesh, [Shard(0)])
    x = distribute_tensor(torch.randn(8, 4), mesh, [Shard(0)])
    w = distribute_tensor(torch.randn(4, 6), mesh, [Replicate()])
    bias = distribute_tensor(torch.zeros(6), mesh, [Replicate()])
    t = distribute_tensor(torch.zeros(8, dtype=torch.long), mesh, [Shard(0)])
    p = distribute_tensor(torch.zeros(8), mesh, [Shard(0)])
    hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001])
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q, q, True),
        "fused_linear_ce": lambda: ops.fused_linear_ce(x, w, bias, t),
        "fused_adam": lambda: ops.fused_adam([p], [p], [p], [p], hyper),
    }
    raised = {}
    for name, fn in calls.items():
        try:
            fn()
            raised[name] = None
        except TypeError as e:
            raised[name] = str(e)
    return {"raised": raised, "world": dist.get_world_size()}


@case
def ckpt(inp):
    """FSDP resume at 4 ranks and at 2 (a file written at 4 ranks), and the
    file the JAX package then reads."""
    from deepflows_tpu_torch.utils.model_utils import (AsyncCheckpointer, load_checkpoint,
                                                       save_checkpoint)

    batches = inp["batches"]
    mesh = make_mesh({"data": 4})
    mesh2 = make_mesh({"data": 2}, [0, 1])

    def fresh(state=None):
        m = loaded("cnn", inp["state"])
        opt = optim.Adam(m.parameters(), lr=1e-3)
        return m, opt

    def run(step, bs):
        return [float(step(torch.from_numpy(x), torch.from_numpy(y).long())) for x, y in bs]

    m_a, o_a = fresh()
    s_a = ShardedTrainStep(m_a, o_a, nn.CrossEntropyLoss(), mesh, param_rules=fsdp_rules(mesh))
    losses_a = run(s_a, batches)
    params_a = params_of(m_a)

    m_b, o_b = fresh()
    s_b = ShardedTrainStep(m_b, o_b, nn.CrossEntropyLoss(), mesh, param_rules=fsdp_rules(mesh))
    run(s_b, batches[:2])
    path = inp["path"]
    save_checkpoint(m_b, o_b, epoch=2, save_path=path)
    with AsyncCheckpointer() as ck:
        ck.save(m_b, o_b, epoch=2, save_path=inp["async_path"])
    dist.barrier()
    out = {"losses_a": losses_a, "params_a": params_a}

    m_c, o_c = fresh()
    load_checkpoint(m_c, o_c, path)
    s_c = ShardedTrainStep(m_c, o_c, nn.CrossEntropyLoss(), mesh, param_rules=fsdp_rules(mesh))
    out["losses_c"] = run(s_c, batches[2:])
    out["params_c"] = params_of(m_c)

    if rank() < 2:  # the 2-rank mesh
        m_r, o_r = fresh()
        load_checkpoint(m_r, o_r, path)
        s_r = ShardedTrainStep(m_r, o_r, nn.CrossEntropyLoss(), mesh2,
                               param_rules=fsdp_rules(mesh2))
        out["losses_r"] = run(s_r, batches[2:])
        out["params_r"] = params_of(m_r)
        out["sizes_r"] = local_sizes(m_r)
    dist.barrier()
    return out


# ---------------------------------------------------------------- ring
def _naive(q, k, v, causal):
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / np.sqrt(d)
    if causal:
        L = s.shape[-1]
        mask = torch.ones(L, L, dtype=torch.bool).triu(1)
        s = torch.where(mask, torch.full((), -1e30), s)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.float()).to(q.dtype)


@case
def ring(inp):
    """Forward and gradients of ring attention on plain tensors every rank
    holds whole ({data: 2, model: 2}), f32 and bf16, causal and not."""
    mesh = make_mesh({"data": 2, "model": 2})
    out = {}
    for key, (q, k, v, w, causal, dtype) in inp["cases"].items():
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        q, k, v = (torch.from_numpy(a).to(dt).requires_grad_(True) for a in (q, k, v))
        o = ring_attention(q, k, v, mesh, "model", causal=causal)
        res = {"out": o.detach().float().numpy(), "dtype": str(o.dtype)}
        if w is not None:
            (o * torch.from_numpy(w)).sum().backward()
            res["grads"] = [t.grad.float().numpy() for t in (q, k, v)]
            qn, kn, vn = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            (_naive(qn, kn, vn, causal) * torch.from_numpy(w)).sum().backward()
            res["ref_grads"] = [t.grad.float().numpy() for t in (qn, kn, vn)]
        res["ref"] = _naive(q.detach(), k.detach(), v.detach(), causal).float().numpy()
        out[key] = res
    from torch.distributed.tensor import Shard, distribute_tensor

    q = distribute_tensor(torch.from_numpy(inp["cases"]["grad_causal"][0]), mesh,
                          [Shard(0), Shard(2)])
    out["dtensor_refused"] = refusal(lambda: ring_attention(q, q, q, mesh, "model"))
    return out


class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The most elements of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


@case
def ring_memory(inp):
    """The largest tensor a rank makes in ring attention over {model: 4}
    and in the gathered (naive) attention, on the whole (B, H, L, D) every
    rank holds."""
    mesh = make_mesh({"model": 4})
    res = {}
    for L in inp["lengths"]:
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 4, L, 16)).astype(np.float32))
        with _Largest() as ring_mode:
            ring_attention(x, x, x, mesh, "model", causal=True, batch_axis=None)
        with _Largest() as naive_mode:
            _naive(x, x, x, True)
        res[L] = (ring_mode.most, naive_mode.most)
    return res


@case
def ring_lm(inp):
    mesh = make_mesh({"data": 2, "model": 2})
    m = loaded("lm", inp["state"], ring=(mesh, "model"))
    opt = optim.Adam(m.parameters(), lr=1e-3)
    step = ShardedTrainStep(m, opt, nn.CrossEntropyLoss(), mesh)
    losses = [float(step(torch.from_numpy(x).long(), torch.from_numpy(y).long()))
              for x, y in inp["batches"]]
    out = {"losses": losses, "params": params_of(m)}
    if rank() == 0:
        m0 = loaded("lm", inp["state"])
        s0 = CompiledTrainStep(m0, optim.Adam(m0.parameters(), lr=1e-3), nn.CrossEntropyLoss())
        out["ref_losses"] = [float(s0(torch.from_numpy(x).long(), torch.from_numpy(y).long()))
                             for x, y in inp["batches"]]
        out["ref_params"] = params_of(m0)
    return out


# --------------------------------------------------------------------- the world
class World:
    """``n`` rank processes running ``cases`` in the background; the test
    process goes on (with the JAX side) and reads ``results()`` when it
    needs them."""

    def __init__(self, cases, inputs, tmpdir, n=4, timeout=240, script=None):
        """``script``: the rank script to start (this file by default)."""
        import subprocess

        self.tmpdir, self.n, self.cases = str(tmpdir), n, list(cases)
        inp = os.path.join(self.tmpdir, "cases.pkl")
        with open(inp, "wb") as f:
            pickle.dump(inputs, f)
        store = os.path.join(self.tmpdir, "store")
        self.out = os.path.join(self.tmpdir, "results")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT] + [
                       q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
        self.procs = [subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), "--rank", str(r),
             "--world", str(n), "--store", store, "--inp", inp, "--out", self.out,
             "--cases", ",".join(self.cases)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        """Every rank's results, ``[rank 0's, rank 1's, ...]``; raises with
        the ranks' output if a rank failed or the time ran out."""
        import subprocess

        if self._results is not None:
            return self._results
        logs = []
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                logs.append(p.communicate()[0].decode(errors="replace")[-4000:])
        res = []
        for r in range(self.n):
            path = f"{self.out}.{r}.pkl"
            if os.path.exists(path):
                with open(path, "rb") as f:
                    res.append(pickle.load(f))
            else:
                res.append({})
        self._results = res
        self._logs = logs
        return res

    def case(self, name):
        """Every rank's result of one case; raises with the traceback of a
        rank that failed it."""
        res = self.results()
        for r, got in enumerate(res):
            if name not in got:
                errors = [v["error"] for v in got.values() if isinstance(v, dict) and "error" in v]
                raise AssertionError(f"rank {r} has no result for {name}:\n"
                                     f"{errors[0] if errors else self._logs[r]}")
            if isinstance(got[name], dict) and "error" in got[name]:
                raise AssertionError(f"rank {r} failed {name}:\n{got[name]['error']}")
        return [got[name] for got in res]


# --------------------------------------------------------------------- main
def main(cases=None):
    """Run the named cases of ``cases`` (this file's by default) on this rank."""
    cases = CASES if cases is None else cases
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    from deepflows_tpu_torch.parallel import init_process_group

    init_process_group("cpu", a.rank, a.world, f"file://{a.store}",
                       timeout=datetime.timedelta(seconds=90))
    with open(a.inp, "rb") as f:
        inp = pickle.load(f)
    results, failed = {"seconds": {}}, False
    for name in a.cases.split(","):
        torch.manual_seed(0)
        t0 = time.perf_counter()
        try:
            results[name] = cases[name](inp.get(name))
            results["seconds"][name] = time.perf_counter() - t0
        except Exception:
            results[name] = {"error": traceback.format_exc()}
            failed = True
            break
    tmp = f"{a.out}.{a.rank}.pkl.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, f"{a.out}.{a.rank}.pkl")
    if failed:
        os._exit(1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
