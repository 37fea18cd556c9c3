#!/usr/bin/env python3
"""Time linear_fused, matmul and fused_linear_ce on one CUDA card, for two
or more trees of deepflows_tpu_torch, each imported in its own process.

    python3 tools/linear_ce_ab.py PARENT_TREE CHANGE_TREE [--sweep] [--report PATH]

Each tree is a directory that holds a deepflows_tpu_torch package (an
unpacked ``git archive`` of another commit, or ``.``).  The trees run in
the order A, B, B, A, so drift of the card or its host over the call
shows as a difference between the two runs of one tree.  Every run builds
its tree's kernels, then times with CUDA events (chip_smoke.event_ms, L2
flushed between launches), on inputs from the same seeds:

- linear_fused at the MLP's three layers (chip_smoke.MLP_SHAPES) beside
  torch.addmm, and matmul at the MLP's forward and backward products (the
  bias-free twin's dW = x^T g and dx = g W^T, as transposed views) and at
  4096^3 beside torch.matmul (TF32 off);
- matmul at (256, K, 100) on the 128 x 128 tile for K from 8 to 1568:
  the slope is the time of one K step of 8 (the parent's only tile; in a
  tree with ops/linear.py _linear_plan, that tile forced);
- fused_linear_ce's backward and forward at the training slice's bf16
  shape (N 8192, D 1024, V 8192) and at GPT-2's head (N 8192, D 768, V
  50257) beside their library calls (the autograd backward of
  torch.matmul + F.cross_entropy, and that forward) and their bounds
  (chip_smoke.cost_bound), with the forward's route as its launch counts
  by route show it and the backward's route (``_bwd_route``; "mma" in a
  tree without it), and in a tree whose backward takes wgmma the mma.sync
  clusters forced beside it; the forward is timed as a caller calls it
  (with the staging copy of w a tree makes), the backward on the w that
  fused_linear_ce hands it (the staged copy, in a tree that stages);
- GPT-2 small (chip_smoke.HF_GPT2) trained in bf16 at B 8 x L 1024 as
  chip_smoke.py's GPT-2 phase trains it: a step's device ms by kernel
  group (the CE's share), a step's device ms with its launches queued
  ahead, its wall ms, and the peak memory of a step;
- for a tree with the plans, a sweep of their choices: every K split of
  the 32 x 32 tile and the 128 x 128 tile at MLP layer 1, every (BM, BV)
  of ops/fused_ce.py _bwd_plan at the slice's CE shape (the mma.sync
  route forced), and, in a tree with _bwd_wgmma_plan, the wgmma
  backward's ring of 2 and 3 stages at the slice's and GPT-2's CE shapes;
- the device time of two bf16 bench-row training steps by kernel group
  (chip_smoke.step_profile, torch.profiler) and of one step with its
  launches queued ahead (chip_smoke.event_ms).

Each run also writes its 4096^3 matmul output and the CE forward's loss
and lse at the slice's shape to a scratch directory: the table prints a
digest of each tree's matmul output (equal digests: the same bits) and the
largest |difference| of loss and lse between the trees.

``--sweep`` then builds copies of the last tree's csrc/linear_f32.cu and
csrc/fused_linear_ce.cu with other compile-time choices (LINEAR_SWEEP: the
large tile's K rows a stage, stages and blocks an SM; CE_SWEEP: the wgmma
forward's vocab tile and stages) and times 4096^3 matmul and the slice's
CE forward on each, and the forward's vocab splits (CE_SPLITS) forced in
turn; every variant's outputs are checked against the source's.

Prints the card's name and power limit and a table of the median of each
tree's runs; with ``--report PATH`` it also writes every run to PATH as
JSON.  It needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from int8_decode_ab import ROOT, load_chip_smoke  # noqa: E402

K_STEPS = (8, 200, 392, 784, 1568)  # matmul (256, K, 100) on the large tile
CE_SHAPE = (8192, 1024, 8192)
GPT2_CE_SHAPE = (8192, 768, 50257)  # GPT-2 small's head at B 8 x L 1024
# Edits made in copies of the kernels' sources for --sweep, each (old, new)
# matching the source once; named by the values they set.  The sources'
# own: the large tile LINEAR_SOURCE, the CE forward (BV 256, 4 stages).
LINEAR_LINES = ("constexpr int TN = 8;\n", "constexpr int BK = 32, STAGES = 4;\n",
                "constexpr int MIN_BLOCKS = 1;\n", "constexpr int KG_UNIT = 4;\n")
LINEAR_SOURCE = (8, 32, 4, 1, 4)  # (TN, BK, stages, blocks an SM, KG_UNIT) of the source
LINEAR_SWEEP = {v: tuple((line, edit) for line, edit in zip(LINEAR_LINES, (
    f"constexpr int TN = {v[0]};\n", f"constexpr int BK = {v[1]}, STAGES = {v[2]};\n",
    f"constexpr int MIN_BLOCKS = {v[3]};\n", f"constexpr int KG_UNIT = {v[4]};\n"))
    if line != edit)
    for v in ((8, 16, 4, 2, 4), (8, 16, 4, 1, 4), (8, 32, 2, 1, 4), (8, 32, 3, 1, 4),
              (8, 32, 4, 1, 1), (16, 32, 4, 1, 1))}
# Parts of the large tile cut from copies (their outputs are wrong; the
# times say what a stage's time is made of)
NO_COPIES = (("    if (t + STAGES - 1 < tiles) load((t + STAGES - 1) % STAGES, t + STAGES - 1);\n",
              ""),
             ("      dft::hopper::mbar_wait(full + t % STAGES, (t / STAGES) & 1);  // stage t has "
              "landed\n",
              "      if (t < STAGES - 1) dft::hopper::mbar_wait(full + t % STAGES, (t / STAGES) & 1);\n"))
NO_BARRIER = ("    __syncthreads();              // ... for every thread; stage t - 1 is free\n", "")
ONE_LOAD = ("      fragments<AK, KG, true, 8, BM, TMA>(a, as, kg);\n"
            "      fragments<BKU, KG, false, TN, BN, TMA>(b, bs, kg);\n",
            "      fragments<AK, KG, true, 8, BM, TMA>(a, as, 0);\n"
            "      fragments<BKU, KG, false, TN, BN, TMA>(b, bs, 0);\n")
LINEAR_MUTANTS = {"no copies": NO_COPIES, "no copies or barrier": NO_COPIES + (NO_BARRIER,),
                  "no copies or barrier, one fragment load a stage": NO_COPIES + (NO_BARRIER,
                                                                                  ONE_LOAD)}
CE_LINE = "constexpr int BV = 256, ST = 4;\n"
CE_SWEEP = {(bv, st): ((CE_LINE, f"constexpr int BV = {bv}, ST = {st};\n"),)
            for bv, st in ((256, 3), (128, 4), (128, 6))}
CE_SPLITS = (1, 2, 4, 8, 16)


def linear_runs(torch, ops, cs, g, flush):
    """{label: {kernel, library}} ms of linear_fused and matmul."""
    dev = torch.device("cuda")
    out = {}
    for m, k, n in cs.MLP_SHAPES:
        x, w, b = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (1, n)))
        out[f"linear_fused {(m, k, n)}"] = {
            "kernel": cs.event_ms(lambda: ops.linear_fused(x, w, b), 20, flush),
            "library": cs.event_ms(lambda: torch.addmm(b, x, w), 20, flush)}
    products = []
    for m, k, n in cs.MLP_SHAPES:  # forward, dW = x^T g, dx = g W^T
        x, w, gy = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (m, n)))
        products += [(f"matmul {(m, k, n)}", x, w), (f"matmul dW {(k, m, n)}", x.t(), gy),
                     (f"matmul dx {(m, n, k)}", gy, w.t())]
    big = torch.randn((4096, 4096), generator=g, device=dev)
    products.append(("matmul 4096^3", big, big.t().contiguous()))
    for label, a, b in products:
        reps = 5 if a.shape[0] == 4096 else 20
        out[label] = {"kernel": cs.event_ms(lambda: ops.matmul(a, b), reps, flush),
                      "library": cs.event_ms(lambda: torch.matmul(a, b), reps, flush)}
    out["matmul 4096^3"]["tile"] = __import__(
        "deepflows_tpu_torch.ops.linear", fromlist=["_"])._linear_plan(4096, 4096, 4096)[0]
    return out, ops.matmul(big, big.t().contiguous())


def digest(t):
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def k_step_runs(torch, ops, g, flush, cs):
    """ms of matmul (256, K, 100) on the 128 x 128 tile, by K."""
    from deepflows_tpu_torch.ops import linear

    plan = getattr(linear, "_linear_plan", None)
    dev = torch.device("cuda")
    out = {}
    try:
        if plan is not None:
            linear._linear_plan = lambda m, n, k: (128, k, 1)
        for k in K_STEPS:
            a, b = (torch.randn(s, generator=g, device=dev) for s in ((256, k), (k, 100)))
            out[k] = cs.event_ms(lambda: ops.matmul(a, b), 20, flush)
    finally:
        if plan is not None:
            linear._linear_plan = plan
    return out


def ce_operands(torch, ops, g, shape=CE_SHAPE):
    dev = torch.device("cuda")
    N, D, V = shape
    x = (torch.randn((N, D), generator=g, device=dev) * 0.5).bfloat16()
    w = (torch.randn((D, V), generator=g, device=dev) * 0.05).bfloat16()
    b = (torch.randn((V,), generator=g, device=dev) * 0.1).bfloat16()
    t = torch.randint(0, V, (N,), generator=g, device=dev)
    gr = torch.rand((N,), generator=g, device=dev) / N
    return x, w, b, t, ops.fused_linear_ce_fwd(x, w, b, t)[1], gr


def ce_runs(torch, ops, cs, ce, flush, label=""):
    """(the forward's route, {kernel: {kernel, library, bound} ms}) of the
    CE at ce's shape; keys end in ``label``."""
    import torch.nn.functional as F

    from deepflows_tpu_torch.ops import fused_ce

    x, w, b, t, lse, gr = ce
    xr, wr, br = (a.detach().requires_grad_() for a in (x, w, b))
    lib = F.cross_entropy((torch.matmul(xr, wr) + br).float(), t, reduction="none")
    routes = fused_ce.fused_linear_ce_fwd.routes
    before = dict(routes)
    ops.fused_linear_ce_fwd(x, w, b, t)
    route = next(r for r in routes if routes[r] > before[r])
    wb = fused_ce._staged(w) if hasattr(fused_ce, "_staged") else w  # what the backward gets
    fwd_args, bwd_args = (x, w, b, t), (x, wb, b, t, lse, gr)
    bwd_route = fused_ce._bwd_route(x, wb) if hasattr(fused_ce, "_bwd_route") else "mma"
    bwd = {"kernel": cs.event_ms(lambda: ops.fused_linear_ce_bwd(*bwd_args), 5, flush),
           "library": cs.event_ms(lambda: torch.autograd.grad(lib, (xr, wr, br), gr,
                                                              retain_graph=True), 5, flush),
           "bound": cs.cost_bound(ops.fused_linear_ce_bwd, *bwd_args)[0], "route": bwd_route}
    if bwd_route == "wgmma":  # the mma.sync clusters forced beside it
        with forced(fused_ce, "_bwd_route", lambda *_: "mma"):
            bwd["mma"] = cs.event_ms(lambda: ops.fused_linear_ce_bwd(*bwd_args), 5, flush)
    return route, {
        "fused_linear_ce_bwd" + label: bwd,
        "fused_linear_ce_fwd" + label: {
            "kernel": cs.event_ms(lambda: ops.fused_linear_ce_fwd(*fwd_args), 5, flush),
            "library": cs.event_ms(lambda: F.cross_entropy((torch.matmul(x, w) + b).float(), t,
                                                           reduction="none"), 5, flush),
            "bound": cs.cost_bound(ops.fused_linear_ce_fwd, *fwd_args)[0]},
    }


class forced:
    """``module.name`` is ``value`` while the block runs."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.intact = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.intact)


def sweeps(torch, ops, cs, g, ce, gce, flush):
    """The plans' choices, each forced in turn; {} for a tree without them."""
    from deepflows_tpu_torch.ops import fused_ce, linear

    if not hasattr(linear, "_linear_plan") or not hasattr(fused_ce, "_bwd_plan"):
        return {}
    dev = torch.device("cuda")
    m, k, n = cs.MLP_SHAPES[0]
    x, w, b = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (1, n)))
    lplan, bplan = linear._linear_plan, fused_ce._bwd_plan
    choices = [(128, k, 1)] + sorted({(32, -(-k // (s * 8)) * 8, -(-k // (-(-k // (s * 8)) * 8)))
                                      for s in range(1, 17)}, key=lambda p: p[2])
    out = {"linear_plan": list(lplan(m, n, k)), "ce_plan": list(bplan(*CE_SHAPE))}
    try:
        lin = {}
        for p in choices:
            linear._linear_plan = lambda *_, p=p: p
            lin[str(p)] = cs.event_ms(lambda: ops.linear_fused(x, w, b), 20, flush)
        out["linear_fused (256, 784, 100)"] = lin
        c = -(-CE_SHAPE[1] // 256)
        cev = {}
        mma = (forced(fused_ce, "_bwd_route", lambda *_: "mma") if hasattr(fused_ce, "_bwd_route")
               else contextlib.nullcontext())
        with mma:
            for bm in (128, 64):
                for bv in (128, 64):
                    fused_ce._bwd_plan = lambda *_, p=(c, bm, bv): p
                    cev[str((c, bm, bv))] = cs.event_ms(
                        lambda: ops.fused_linear_ce_bwd(*ce), 5, flush)
        out["fused_linear_ce_bwd slice"] = cev
    finally:
        linear._linear_plan, fused_ce._bwd_plan = lplan, bplan
    if hasattr(fused_ce, "_bwd_wgmma_plan"):
        for key, shape, operands in (("slice", CE_SHAPE, ce), ("GPT-2 head", GPT2_CE_SHAPE, gce)):
            c, tile, _ = fused_ce._bwd_wgmma_plan(*shape)
            args = operands[:1] + (fused_ce._staged(operands[1]),) + operands[2:]
            out.setdefault("wgmma_plan", []).append(list(fused_ce._bwd_wgmma_plan(*shape)))
            wg = {}
            for stages in (3, 2):
                with forced(fused_ce, "_bwd_wgmma_plan", lambda *_, p=(c, tile, stages): p):
                    wg[str((c, tile, stages))] = cs.event_ms(
                        lambda: ops.fused_linear_ce_bwd(*args), 5, flush)
            out[f"fused_linear_ce_bwd wgmma {key}"] = wg
    return out


def train_runs(torch, cs):
    """Device ms of the bf16 bench-row step: by kernel over two steps, and
    one step with its launches queued ahead."""
    import numpy as np

    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import TransformerLM

    dt.manual_seed(0)
    lm = TransformerLM(**cs.TRAIN, device="cuda", flash=True)
    step = CompiledTrainStep(lm.trunk(), optim.Adam(lm.parameters(), **cs.ADAM, fused=True),
                             nn.LMHeadCrossEntropy(lm.head), compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    V = cs.TRAIN["vocab_size"]
    x, y = (torch.as_tensor(rng.integers(0, V, (cs.TRAIN_B, cs.TRAIN_L)).astype(np.int32),
                            device="cuda") for _ in range(2))
    for _ in range(cs.WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    prof = cs.step_profile(torch, step, x, y)
    return {"profile_ms": prof, "profile_total_ms": sum(prof.values()),
            "step_device_ms": cs.event_ms(lambda: step(x, y), 3)}


def gpt2_runs(torch, cs):
    """GPT-2 small trained in bf16 as chip_smoke.gpt2_phase trains it (B 8
    x L 1024, fused Adam, LMHeadCrossEntropy): the losses of its first
    steps (chip_smoke.py's three, then the timed ones), device ms a step by
    kernel group over two steps, one step's device ms with its launches queued
    ahead, the median wall ms of three synchronised steps, and the peak
    memory of one step (bytes allocated above what the model and its Adam
    state hold)."""
    import time

    import numpy as np

    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.utils import build_gpt2_from_hf_config, load_hf_gpt2_state

    cfg = cs.HF_GPT2
    lm = build_gpt2_from_hf_config(cfg, device="cuda")
    load_hf_gpt2_state(lm, cs.seeded_arrays(cs.hf_gpt2_shapes(cfg), cs.HF_SEED + 1))
    step = CompiledTrainStep(lm.trunk(), optim.Adam(lm.parameters(), **cs.GPT2_ADAM, fused=True),
                             nn.LMHeadCrossEntropy(lm.head), compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(cs.HF_SEED)
    L, V = cfg.n_positions, cfg.vocab_size
    x, y = (torch.as_tensor(rng.integers(0, V, (cs.GPT2_B, L)), device="cuda") for _ in range(2))
    losses = [float(step(x, y)) for _ in range(cs.GPT2_STEPS)]  # chip_smoke's steps
    torch.cuda.synchronize()
    prof = cs.step_profile(torch, step, x, y)
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        wall.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"profile_ms": prof, "profile_total_ms": sum(prof.values()),
           "ce_ms": sum(v for k, v in prof.items() if k.startswith("fused_linear_ce")),
           "step_device_ms": cs.event_ms(lambda: step(x, y), 3),
           "step_wall_ms": statistics.median(wall), "peak_bytes": peak,
           "peak_above_held_bytes": peak - held, "losses": losses}
    del lm, step
    torch.cuda.empty_cache()
    return out


def child(tree, save):
    """One tree's timings, printed as one JSON line; its 4096^3 product and
    CE forward outputs saved to ``save``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    if not ops.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {ops.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    ce = ce_operands(torch, ops, g)
    linear, product = linear_runs(torch, ops, cs, g, flush)
    route, ce_ms = ce_runs(torch, ops, cs, ce, flush)
    loss, lse = ops.fused_linear_ce_fwd(*ce[:4])
    gce = ce_operands(torch, ops, g, GPT2_CE_SHAPE)
    gpt2_route, gpt2_ms = ce_runs(torch, ops, cs, gce, flush, " GPT-2 head")
    ce_ms.update(gpt2_ms)
    gloss, glse = ops.fused_linear_ce_fwd(*gce[:4])
    torch.save({"matmul": product.cpu(), "loss": loss.cpu(), "lse": lse.cpu(),
                "gpt2_loss": gloss.cpu(), "gpt2_lse": glse.cpu()}, save)
    k_steps, sweep = k_step_runs(torch, ops, g, flush, cs), sweeps(torch, ops, cs, g, ce, gce, flush)
    del gce, gloss, glse
    print(json.dumps(dict(
        tree=tree, linear=linear, matmul_digest=digest(product), ce_fwd_route=route,
        ce_fwd_route_gpt2=gpt2_route, k_steps=k_steps, ce=ce_ms, sweeps=sweep,
        train=train_runs(torch, cs), gpt2=gpt2_runs(torch, cs))))


def start_copies(build_dir, source, copies):
    """Starts one nvcc for each copy of csrc/<source> with its edits ({name:
    edits}), with the package's flags, into ``build_dir``; returns {name:
    (library, process, log)}."""
    from deepflows_tpu_torch.ops import _build

    src = (_build.CSRC / source).read_text()
    jobs = {}
    for name, edits in copies.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"linear_ce_ab: the edit {old!r} does not match {source} once")
            text = text.replace(old, new)
        stem = Path(source).stem + "_" + re.sub(r"\W", "_", str(name))
        cu, so, log = (build_dir / f"{stem}{ext}" for ext in (".cu", ".so", ".log"))
        cu.write_text(text)
        with open(log, "w") as f:
            jobs[name] = so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                 str(cu)], stdout=f, stderr=subprocess.STDOUT), log
    return jobs


def ptxas_report(text, kernel):
    """(registers, spill store bytes) of the first instance in a ptxas -v
    log whose mangled name holds ``kernel``."""
    for block in text.split("Compiling entry function")[1:]:
        if kernel in block.split("\n", 1)[0]:
            return (int(re.search(r"Used (\d+) registers", block).group(1)),
                    int(re.search(r"(\d+) bytes spill stores", block).group(1)))
    return None


def finish_copies(jobs, name, argtypes, kernel):
    """{copy: (its C function ``name``, ptxas_report of ``kernel``)} of the
    copies start_copies built."""
    fns = {}
    for copy, (so, proc, log) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"linear_ce_ab: nvcc failed on the copy {copy!r}:\n"
                             + log.read_text()[-3000:])
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[copy] = fn, ptxas_report(log.read_text(), kernel)
    return fns


class swapped:
    """The package's wrappers call ``fn`` in place of its C function
    ``name`` while the block runs."""

    def __init__(self, name, fn):
        from deepflows_tpu_torch.ops import _build

        self.functions, self.name, self.fn = _build._functions, name, fn

    def __enter__(self):
        self.intact = self.functions[self.name]
        self.functions[self.name] = self.fn

    def __exit__(self, *exc):
        self.functions[self.name] = self.intact


def sweep_child(tree):
    """The compile-time choices of the tree's large matmul tile and wgmma CE
    forward, built from copies, and the forward's vocab splits; one JSON
    line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build, fused_ce

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    with tempfile.TemporaryDirectory() as tmp:
        jobs = (start_copies(Path(tmp), "linear_f32.cu", {**LINEAR_SWEEP, **LINEAR_MUTANTS}),
                start_copies(Path(tmp), "fused_linear_ce.cu", CE_SWEEP))
        g = torch.Generator(device=dev).manual_seed(0)
        a, b = (torch.randn((4096, 4096), generator=g, device=dev) for _ in range(2))
        ref = ops.matmul(a, b)
        x, w, bias, t, _, _ = ce_operands(torch, ops, g)
        ref_ce = ops.fused_linear_ce_fwd(x, w, bias, t)
        out = {"linear": {str(LINEAR_SOURCE): dict(ms=cs.event_ms(lambda: ops.matmul(a, b), 5, flush),
                                                 same=True)},
               "ce": {str((256, 4)): dict(ms=cs.event_ms(
                   lambda: ops.fused_linear_ce_fwd(x, w, bias, t), 10, flush), err=0.0)},
               "splits": {}}
        plan, tiles = fused_ce._fwd_plan, -(-CE_SHAPE[2] // 256)
        try:
            for sp in CE_SPLITS:
                per = -(-tiles // sp)
                fused_ce._fwd_plan = lambda n, v, route, p=(-(-tiles // per), per): p
                got = ops.fused_linear_ce_fwd(x, w, bias, t)
                out["splits"][sp] = dict(
                    ms=cs.event_ms(lambda: ops.fused_linear_ce_fwd(x, w, bias, t), 10, flush),
                    err=max((p - q).abs().max().item() for p, q in zip(got, ref_ce)))
        finally:
            fused_ce._fwd_plan = plan
        # the instance 4096^3 runs: no epilogue, K A's unit stride, N B's, TMA
        lin = finish_copies(jobs[0], "dft_linear_f32", _build._functions["dft_linear_f32"].argtypes,
                            "linear_f32_kernelILi0ELb1ELb0ELb1E")
        for name, (fn, regs) in lin.items():
            with swapped("dft_linear_f32", fn):
                same = torch.equal(ops.matmul(a, b), ref)
                out["linear"][str(name)] = dict(
                    ms=cs.event_ms(lambda: ops.matmul(a, b), 5, flush), same=same, regs=regs)
        ce = finish_copies(jobs[1], "dft_flce_fwd", _build._functions["dft_flce_fwd"].argtypes,
                           "ce_fwd_wgmmaI13__nv_bfloat16")
        tile = fused_ce._FWD_TILE
        for (bv, st), (fn, regs) in ce.items():
            fused_ce._FWD_TILE = dict(tile, wgmma=bv)
            try:
                with swapped("dft_flce_fwd", fn):
                    got = ops.fused_linear_ce_fwd(x, w, bias, t)
                    out["ce"][str((bv, st))] = dict(
                        ms=cs.event_ms(lambda: ops.fused_linear_ce_fwd(x, w, bias, t), 10, flush),
                        err=max((p - q).abs().max().item() for p, q in zip(got, ref_ce)),
                        regs=regs)
            finally:
                fused_ce._FWD_TILE = tile
    print(json.dumps(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    parser.add_argument("--save", metavar="PATH", help=argparse.SUPPRESS)
    parser.add_argument("--sweep-child", metavar="TREE", help=argparse.SUPPRESS)
    parser.add_argument("--sweep", action="store_true",
                        help="also sweep the last tree's compile-time choices (LINEAR_SWEEP, "
                             "CE_SWEEP) and the CE forward's splits")
    parser.add_argument("--report", metavar="PATH",
                        help="also write every run to PATH as JSON")
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.save)
    if args.sweep_child:
        return sweep_child(args.sweep_child)
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("linear_ce_ab: needs a CUDA card and two trees", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    card = cs.card_line()
    order = args.trees + args.trees[::-1]
    runs, saved = [], tempfile.mkdtemp()
    for i, tree in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                              "--save", os.path.join(saved, f"{i}.pt")],
                             capture_output=True, text=True, cwd=ROOT)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"timed {tree}", flush=True)
    sweep = None
    if args.sweep:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--sweep-child",
                              args.trees[-1]], capture_output=True, text=True, cwd=ROOT)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            return out.returncode
        sweep = json.loads(out.stdout.strip().splitlines()[-1])
    by_tree = {t: [r for r in runs if r["tree"] == t] for t in args.trees}
    outputs = {t: torch.load(os.path.join(saved, f"{order.index(t)}.pt")) for t in args.trees}

    def med(tree, get):
        return statistics.median(get(r) for r in by_tree[tree])

    def row(label, get, unit=1e3, fmt="{:.2f}"):
        vals = [med(t, get) * unit for t in args.trees]
        print(f"  {label}: " + " / ".join(fmt.format(v) for v in vals))

    print(card)
    print("us a call (median of each tree's runs), L2 flushed: " + " / ".join(args.trees))
    for group in ("linear", "ce"):
        for key in runs[0][group]:
            for kind in ("kernel", "library"):
                row(f"{key} {kind}", lambda r, key=key, kind=kind: r[group][key][kind])
            if "bound" in runs[0][group][key]:
                print(f"  {key} bound: {runs[0][group][key]['bound'] * 1e3:.2f}")
            if "route" in runs[0][group][key]:
                print(f"  {key} route: " + " / ".join(
                    by_tree[t][0][group][key].get("route", "?") for t in args.trees))
            for t in args.trees:
                if "mma" in by_tree[t][0][group][key]:
                    print(f"  {key} mma.sync forced in {t}: "
                          f"{med(t, lambda r, key=key: r[group][key]['mma']) * 1e3:.2f}")
    first = outputs[args.trees[0]]
    for t in args.trees:
        digests = sorted({r["matmul_digest"] for r in by_tree[t]})
        d = {k: (outputs[t][k] - first[k]).abs().max().item() for k in ("loss", "lse")}
        print(f"  {t}: matmul 4096^3 on the {by_tree[t][0]['linear']['matmul 4096^3'].get('tile', 128)}"
              f" tile, output digest {', '.join(digests)}; bitwise equal to {args.trees[0]}'s: "
              f"{torch.equal(outputs[t]['matmul'], first['matmul'])}; CE forward on the "
              f"{by_tree[t][0]['ce_fwd_route']} route, max |d| from {args.trees[0]}'s: loss "
              f"{d['loss']:.3g}, lse {d['lse']:.3g}")
        gd = {k: (outputs[t][k] - first[k]).abs().max().item() for k in ("gpt2_loss", "gpt2_lse")}
        print(f"  {t}: CE forward at GPT-2's head on the {by_tree[t][0]['ce_fwd_route_gpt2']} "
              f"route, max |d| from {args.trees[0]}'s: loss {gd['gpt2_loss']:.3g}, lse "
              f"{gd['gpt2_lse']:.3g}")
    print("matmul (256, K, 100) on the 128 x 128 tile, us by K " + str(K_STEPS) + ":")
    for t in args.trees:
        vals = [med(t, lambda r, k=k: r["k_steps"][str(k)]) * 1e3 for k in K_STEPS]
        slope = (vals[-1] - vals[0]) / ((K_STEPS[-1] - K_STEPS[0]) / 8)
        print(f"  {t}: " + ", ".join(f"{v:.2f}" for v in vals)
              + f"; {slope:.4f} us a K step of 8")
    for t in args.trees:
        sw = by_tree[t][0]["sweeps"]
        if not sw:
            continue
        print(f"plan sweep of {t} (us; the plan's choice: linear {sw['linear_plan']}, CE "
              f"{sw['ce_plan']}; wgmma CE {sw.get('wgmma_plan')}):")
        for key in ("linear_fused (256, 784, 100)", "fused_linear_ce_bwd slice",
                    "fused_linear_ce_bwd wgmma slice", "fused_linear_ce_bwd wgmma GPT-2 head"):
            if key not in sw:
                continue
            print(f"  {key}: " + ", ".join(
                f"{p} {med(t, lambda r, p=p: r['sweeps'][key][p]) * 1e3:.2f}" for p in sw[key]))
    print("bf16 training step, device ms:")
    row("by kernel, sum of torch.profiler (2 steps)",
        lambda r: r["train"]["profile_total_ms"], 1, "{:.3f}")
    row("one step, launches queued ahead", lambda r: r["train"]["step_device_ms"], 1, "{:.3f}")
    names = sorted({n for r in runs for n in r["train"]["profile_ms"]})
    for name in names:
        row(name, lambda r, name=name: r["train"]["profile_ms"].get(name, 0.0), 1, "{:.3f}")
    print("GPT-2 small, bf16 training step (B 8 x L 1024):")
    row("device ms by kernel, sum of torch.profiler (2 steps)",
        lambda r: r["gpt2"]["profile_total_ms"], 1, "{:.3f}")
    row("of it the CE's kernels", lambda r: r["gpt2"]["ce_ms"], 1, "{:.3f}")
    row("one step, launches queued ahead, device ms", lambda r: r["gpt2"]["step_device_ms"], 1,
        "{:.3f}")
    row("wall ms (median of 3)", lambda r: r["gpt2"]["step_wall_ms"], 1, "{:.3f}")
    row("peak memory of a step, MiB", lambda r: r["gpt2"]["peak_bytes"], 2**-20, "{:.1f}")
    row("of it above the model and its state, MiB", lambda r: r["gpt2"]["peak_above_held_bytes"],
        2**-20, "{:.1f}")
    names = sorted({n for r in runs for n in r["gpt2"]["profile_ms"]})
    for name in names:
        row(name, lambda r, name=name: r["gpt2"]["profile_ms"].get(name, 0.0), 1, "{:.3f}")
    for t in args.trees:
        print(f"  {t} losses: " + ", ".join(f"{v:.4f}" for v in by_tree[t][0]["gpt2"]["losses"]))
    if sweep:
        print(f"sweep of {args.trees[-1]} (us; outputs against the source's build):")
        for key, what in (("linear", "matmul 4096^3 by (TN, BK, stages, blocks an SM, "
                                      "KG_UNIT)"),
                          ("ce", "CE forward by (BV, stages)"),
                          ("splits", "CE forward (BV 256, 4 stages) by vocab splits")):
            print(f"  {what}: " + "; ".join(
                f"{k} {v['ms'] * 1e3:.2f}"
                + (f" bitwise {v['same']}" if "same" in v else f" max |d| {v['err']:.3g}")
                + (f" (registers, spill bytes) {tuple(v['regs'])}" if "regs" in v else "")
                for k, v in sweep[key].items()))
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs, sweep=sweep), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
