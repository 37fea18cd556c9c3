#!/usr/bin/env python3
"""Time int8_matmul and w8a8_matmul at prefill M on one CUDA card, for two
or more trees of deepflows_tpu_torch, each imported in its own process.

    python3 tools/int8_prefill_ab.py PARENT_TREE CHANGE_TREE [--report PATH]

Each tree is a directory that holds a deepflows_tpu_torch package (an
unpacked ``git archive`` of another commit, or ``.``).  The trees run in
the order A, B, B, A, so drift of the card or its host over the call
shows as a difference between the two runs of one tree.  Every run builds
its tree's kernels, then times with CUDA events (chip_smoke.event_ms, L2
flushed between launches), on inputs from the same seeds:

- the decoder's four layer shapes (qkv, o, fc1, fc2 of chip_smoke.SHAPES)
  at M 1536 (a B 8 prefill) and 192 (B 1): int8_matmul with bf16 x (bf16
  out) and with f32 x (f32 out), and w8a8_matmul (bf16 out), one call
  each, beside torch.matmul on the dequantised bf16 weight and
  torch._int_mm on the int8 operands;
- one prefill's 49 calls (chip_smoke.forward_timing: 48 at M 1536 over 12
  layers of distinct weights and the head at M 8) with the library calls
  beside them;
- one decode step's 49 calls (chip_smoke.decode_step_timing, M 8), to show
  the decode path unchanged;
- for a tree with the tensor-core prefill tile (ops/quant.py
  _prefill_plan), each of its tile heights forced in turn at each of
  those shapes (int8 with bf16 and f32 x, w8a8): the sweep that the
  plan's choice is held against.

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

KINDS = ("int8_bf16", "int8_f32", "w8a8", "matmul", "int_mm")


def shape_runs(torch, ops, cs, x, wq, s):
    """The calls timed at one shape, on x in bf16 (int8_bf16, w8a8 and the
    library calls) and f32 (int8_f32), each bound to this shape's operands."""
    xb = x.bfloat16()
    xq, sx = ops.quantize_int8_rows(xb)
    wd = (wq.float() * s).bfloat16()
    xl, wl = cs.int_mm_operands(torch, xq, wq)
    return {
        "int8_bf16": lambda: ops.int8_matmul(xb, wq, s),
        "int8_f32": lambda: ops.int8_matmul(x, wq, s),
        "w8a8": lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.bfloat16),
        "matmul": lambda: torch.matmul(xb, wd),
        "int_mm": lambda: torch._int_mm(xl, wl),
    }


def child(tree):
    """One tree's timings, printed as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build, quant

    if not ops.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {ops.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shapes, cases = {}, {}
    for M in (cs.PREFILL_M, cs.MODEL["max_len"]):
        for name in ("qkv", "o", "fc1", "fc2"):
            K, N = cs.SHAPES[name]
            x = torch.randn((M, K), generator=g, device=dev)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            runs = cases[f"M={M} {name}"] = shape_runs(torch, ops, cs, x, wq, s)
            shapes[f"M={M} {name}"] = {
                k: cs.event_ms(f, 20, flush_buf.zero_) for k, f in runs.items()}
    tiles = {}
    plan = getattr(quant, "_prefill_plan", None)
    if plan is not None:
        try:
            for tile_m in quant._PREFILL_MS:
                quant._prefill_plan = lambda m, n, k, t=tile_m: (t, quant._PREFILL_N)
                tiles[tile_m] = {key: {k: cs.event_ms(runs[k], 20, flush_buf.zero_)
                                       for k in KINDS[:3]} for key, runs in cases.items()}
        finally:
            quant._prefill_plan = plan
        tiles["plan"] = {key: plan(int(key.split()[0][2:]), *cs.SHAPES[key.split()[1]][::-1])[0]
                         for key in cases}
    pre_ms, p_int8, p_w8a8, _ = cs.forward_timing(torch, ops, cs.PREFILL_M)
    step_ms, b_int8, b_w8a8, _ = cs.decode_step_timing(torch, ops)
    print(json.dumps(dict(
        tree=tree, shapes=shapes, tiles=tiles, prefill=pre_ms, step=step_ms,
        prefill_bound_ms=dict(int8=p_int8[0], w8a8=p_w8a8[0]),
        step_bound_ms=dict(int8=b_int8[0], w8a8=b_w8a8[0]))))


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
        print("int8_prefill_ab: needs a CUDA card and two trees", file=sys.stderr)
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

    print(card)
    print("us a call (median of each tree's runs), L2 flushed: " + " / ".join(args.trees))
    for key in runs[0]["shapes"]:
        cells = []
        for kind in KINDS:
            vals = [med(t, lambda r: r["shapes"][key][kind]) * 1e3 for t in args.trees]
            cells.append(f"{kind} " + " / ".join(f"{v:.2f}" for v in vals))
        print(f"  {key:10s} " + "; ".join(cells))
    for tree in args.trees:
        if not by_tree[tree][0]["tiles"]:
            continue
        plan = by_tree[tree][0]["tiles"]["plan"]
        print(f"tile sweep of {tree}, us a call (int8 bf16 x / int8 f32 x / w8a8), "
              "* the plan's tile:")
        for key in runs[0]["shapes"]:
            cells = []
            for t in by_tree[tree][0]["tiles"]:
                if t == "plan":
                    continue
                vals = [med(tree, lambda r: r["tiles"][t][key][k]) * 1e3 for k in KINDS[:3]]
                mark = "*" if str(plan[key]) == t else " "
                cells.append(f"{mark}BM {t}: " + " / ".join(f"{v:.2f}" for v in vals))
            print(f"  {key:10s} " + "; ".join(cells))
    for what in ("prefill", "step"):
        for kind in runs[0][what]:
            vals = [med(t, lambda r: r[what][kind]) for t in args.trees]
            print(f"{what} ({cs.PER_FORWARD} calls) {kind}: "
                  + " / ".join(f"{v:.4f}" for v in vals) + " ms")
        print(f"{what} bound: int8 {runs[0][what + '_bound_ms']['int8']:.4f} ms, "
              f"w8a8 {runs[0][what + '_bound_ms']['w8a8']:.4f} ms")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
