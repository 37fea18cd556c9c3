#!/usr/bin/env python3
"""Time int8_matmul and w8a8_matmul at decode M on one CUDA card, for two
or more trees of deepflows_tpu_torch, each imported in its own process.

    python3 tools/int8_decode_ab.py PARENT_TREE CHANGE_TREE [--report PATH]

Each tree is a directory that holds a deepflows_tpu_torch package (an
unpacked ``git archive`` of another commit, or ``.``).  The trees run in
the order A, B, B, A, so drift of the card or its host over the call
shows as a difference between the two runs of one tree.  Every run builds
its tree's kernels, then times with CUDA events (chip_smoke.event_ms, L2
flushed between launches), on inputs from the same seeds:

- each of the decoder's five (K, N) shapes (chip_smoke.SHAPES) at M 1, 2,
  5 and 8: int8_matmul with bf16 x (bf16 out) and with f32 x (f32 out),
  and w8a8_matmul (bf16 out), one call each;
- one decode step's 49 calls (chip_smoke.decode_step_timing: M 8, bf16 x,
  12 layers of distinct weights and the head), with the library calls
  beside them;
- the same step under torch.profiler: each kernel's device time, by the
  decoder shape it serves, and the idle time between kernels, for both
  kernels and torch.matmul on the dequantised weights.

Prints the card's name and power limit and a table of the median of each
tree's runs; with ``--report PATH`` it also writes every run to PATH as
JSON.  It needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_step(torch, ops, cs):
    """Device time of each kernel of one decode step's 49 calls (median of
    5 steps, us, by decoder shape), the median idle time between two of
    them and the step's span, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    calls, names = [], []
    for layer in range(cs.MODEL["depth"] + 1):
        for name in ("head",) if layer == cs.MODEL["depth"] else ("qkv", "o", "fc1", "fc2"):
            K, N = cs.SHAPES[name]
            x = torch.randn((8, K), generator=g, device=dev).to(torch.bfloat16)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            odt = torch.float32 if name == "head" else torch.bfloat16
            calls.append((x, *ops.quantize_int8_rows(x), wq, s, (wq.float() * s).bfloat16(), odt))
            names.append(name)
    runs = {
        "int8_matmul": lambda: [ops.int8_matmul(x, wq, s, out_dtype=o)
                                for x, _, _, wq, s, _, o in calls],
        "w8a8_matmul": lambda: [ops.w8a8_matmul(xq, sx, wq, s, out_dtype=o)
                                for _, xq, sx, wq, s, _, o in calls],
        "library": lambda: [torch.matmul(x, wd) for x, _, _, _, _, wd, _ in calls],
    }
    out = {}
    for kind, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                torch.cuda._sleep(20_000_000)  # the step's launches queue behind it
                fn()
            torch.cuda.synchronize()
        ks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
        per = len(ks) // 5  # the library may launch more than one kernel a call
        steps = [ks[i * per:(i + 1) * per] for i in range(5)]
        r = dict(kernels_a_step=per,
                 span_us=statistics.median(st[-1][1] - st[0][0] for st in steps),
                 busy_us=statistics.median(sum(b - a for a, b in st) for st in steps),
                 gap_us=statistics.median(st[i][0] - st[i - 1][1] for st in steps
                                          for i in range(1, per)))
        if per == len(names):
            for name in cs.SHAPES:
                r[name] = statistics.median(b - a for st in steps
                                            for (a, b), n in zip(st, names) if n == name)
        out[kind] = r
    return out


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
    shapes = {}
    for M in (1, 2, 5, 8):
        for name, (K, N) in cs.SHAPES.items():
            x = torch.randn((M, K), generator=g, device=dev)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            xb = x.bfloat16()
            xq, sx = ops.quantize_int8_rows(xb)
            runs = {
                "int8_bf16": lambda: ops.int8_matmul(xb, wq, s),
                "int8_f32": lambda: ops.int8_matmul(x, wq, s),
                "w8a8": lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.bfloat16),
            }
            shapes[f"M={M} {name}"] = {
                k: cs.event_ms(f, 20, flush_buf.zero_) for k, f in runs.items()}
    step_ms, b_int8, b_w8a8, _ = cs.decode_step_timing(torch, ops)
    print(json.dumps(dict(tree=tree, shapes=shapes, step=step_ms, step_bound_ms=dict(
        int8=b_int8[0], w8a8=b_w8a8[0]), profile=profile_step(torch, ops, cs))))


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
        print("int8_decode_ab: needs a CUDA card and two trees", file=sys.stderr)
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
    print("us a call (median of each tree's runs), L2 flushed: "
          + " | ".join(args.trees))
    for key in runs[0]["shapes"]:
        cells = []
        for kind in ("int8_bf16", "int8_f32", "w8a8"):
            vals = [med(t, lambda r: r["shapes"][key][kind]) * 1e3 for t in args.trees]
            cells.append(f"{kind} " + " / ".join(f"{v:.2f}" for v in vals))
        print(f"  {key:10s} " + "; ".join(cells))
    for kind in runs[0]["step"]:
        vals = [med(t, lambda r: r["step"][kind]) for t in args.trees]
        print(f"step ({cs.PER_FORWARD} calls) {kind}: " + " / ".join(f"{v:.4f}" for v in vals)
              + " ms")
    print("device time by torch.profiler, us (median of each tree's runs):")
    for kind, r0 in runs[0]["profile"].items():
        for key in r0:
            vals = [med(t, lambda r: r["profile"][kind][key]) for t in args.trees]
            print(f"  {kind} {key}: " + " / ".join(f"{v:.2f}" for v in vals))
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
