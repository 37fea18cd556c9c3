#!/usr/bin/env python3
"""Time linear_fused, matmul and fused_linear_ce on one CUDA card, for two
or more trees of deepflows_tpu_torch, each imported in its own process.

    python3 tools/linear_ce_ab.py PARENT_TREE CHANGE_TREE [--report PATH]

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
  shape (N 8192, D 1024, V 8192) beside their library calls (the autograd
  backward of torch.matmul + F.cross_entropy, and that forward);
- for a tree with the plans, a sweep of their choices: every K split of
  the 32 x 32 tile and the 128 x 128 tile at MLP layer 1, and every
  (BM, BV) of ops/fused_ce.py _bwd_plan at the slice's CE shape;
- the device time of two bf16 bench-row training steps by kernel
  (chip_smoke.step_profile, torch.profiler) and of one step with its
  launches queued ahead (chip_smoke.event_ms).

Prints the card's name and power limit and a table of the median of each
tree's runs; with ``--report PATH`` it also writes every run to PATH as
JSON.  It needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from int8_decode_ab import ROOT, load_chip_smoke  # noqa: E402

K_STEPS = (8, 200, 392, 784, 1568)  # matmul (256, K, 100) on the large tile
CE_SHAPE = (8192, 1024, 8192)


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
    return out


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


def ce_operands(torch, ops, g):
    dev = torch.device("cuda")
    N, D, V = CE_SHAPE
    x = (torch.randn((N, D), generator=g, device=dev) * 0.5).bfloat16()
    w = (torch.randn((D, V), generator=g, device=dev) * 0.05).bfloat16()
    b = (torch.randn((V,), generator=g, device=dev) * 0.1).bfloat16()
    t = torch.randint(0, V, (N,), generator=g, device=dev)
    gr = torch.rand((N,), generator=g, device=dev) / N
    return x, w, b, t, ops.fused_linear_ce_fwd(x, w, b, t)[1], gr


def ce_runs(torch, ops, cs, ce, flush):
    import torch.nn.functional as F

    x, w, b, t, lse, gr = ce
    xr, wr, br = (a.detach().requires_grad_() for a in (x, w, b))
    lib = F.cross_entropy((torch.matmul(xr, wr) + br).float(), t, reduction="none")
    return {
        "fused_linear_ce_bwd": {
            "kernel": cs.event_ms(lambda: ops.fused_linear_ce_bwd(x, w, b, t, lse, gr), 5, flush),
            "library": cs.event_ms(lambda: torch.autograd.grad(lib, (xr, wr, br), gr,
                                                               retain_graph=True), 5, flush)},
        "fused_linear_ce_fwd": {
            "kernel": cs.event_ms(lambda: ops.fused_linear_ce_fwd(x, w, b, t), 5, flush),
            "library": cs.event_ms(lambda: F.cross_entropy((torch.matmul(x, w) + b).float(), t,
                                                           reduction="none"), 5, flush)},
    }


def sweeps(torch, ops, cs, g, ce, flush):
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
        for bm in (128, 64):
            for bv in (128, 64):
                fused_ce._bwd_plan = lambda *_, p=(c, bm, bv): p
                cev[str((c, bm, bv))] = cs.event_ms(
                    lambda: ops.fused_linear_ce_bwd(*ce), 5, flush)
        out["fused_linear_ce_bwd slice"] = cev
    finally:
        linear._linear_plan, fused_ce._bwd_plan = lplan, bplan
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


def child(tree):
    """One tree's timings, printed as one JSON line."""
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
    print(json.dumps(dict(
        tree=tree, linear=linear_runs(torch, ops, cs, g, flush),
        k_steps=k_step_runs(torch, ops, g, flush, cs), ce=ce_runs(torch, ops, cs, ce, flush),
        sweeps=sweeps(torch, ops, cs, g, ce, flush), train=train_runs(torch, cs))))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    parser.add_argument("--report", metavar="PATH",
                        help="also write every run to PATH as JSON")
    args = parser.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("linear_ce_ab: needs a CUDA card and two trees", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    card = cs.card_line()
    order = args.trees + args.trees[::-1]
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True, cwd=ROOT)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"timed {tree}", flush=True)
    by_tree = {t: [r for r in runs if r["tree"] == t] for t in args.trees}

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
              f"{sw['ce_plan']}):")
        for key in ("linear_fused (256, 784, 100)", "fused_linear_ce_bwd slice"):
            print(f"  {key}: " + ", ".join(
                f"{p} {med(t, lambda r, p=p: r['sweeps'][key][p]) * 1e3:.2f}" for p in sw[key]))
    print("bf16 training step, device ms:")
    row("by kernel, sum of torch.profiler (2 steps)",
        lambda r: r["train"]["profile_total_ms"], 1, "{:.3f}")
    row("one step, launches queued ahead", lambda r: r["train"]["step_device_ms"], 1, "{:.3f}")
    for name in runs[0]["train"]["profile_ms"]:
        row(name, lambda r, name=name: r["train"]["profile_ms"].get(name, 0.0), 1, "{:.3f}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
