#!/usr/bin/env python3
"""Time int8_matmul and w8a8_matmul at decode and stream M on one CUDA card,
for two or more trees of deepflows_tpu_torch, each imported in its own
process.

    python3 tools/int8_decode_ab.py PARENT_TREE CHANGE_TREE [--down] [--report PATH]

Each tree is a directory that holds a deepflows_tpu_torch package (an
unpacked ``git archive`` of another commit, or ``.``).  The trees run in
the order A, B, B, A, so drift of the card or its host over the call
shows as a difference between the two runs of one tree.  Every run builds
its tree's kernels, then times with CUDA events (chip_smoke.event_ms, L2
flushed between launches), on inputs from the same seeds:

- each of the decoder's five (K, N) shapes (chip_smoke.SHAPES) at M 1, 2,
  5 and 8: int8_matmul with bf16 x (bf16 out) and with f32 x (f32 out),
  and w8a8_matmul (bf16 out), one call each;
- Mistral's five matrices (chip_smoke.MISTRAL_SHAPES) at M 1, 8, 16, 24,
  32, 40, 48, 64, 96 and 128, the same three calls on the route the tree's
  plan takes: the sweep that sets quant.STREAM_M, run on a tree whose
  stream takes every M to be swept (stream::MAX_NT and quant.STREAM_M
  raised together);
- one decode step's 49 calls (chip_smoke.decode_step_timing: M 8, bf16 x,
  12 layers of distinct weights and the head), a Llama decode step's 33
  (M 8) and a speculative verify forward's 33 (M 40, the head too) at
  Mistral's widths, depth 8, with the plain twins and library calls
  beside them;
- the same 49-call step under torch.profiler: each kernel's device time,
  by the decoder shape it serves, and the idle time between kernels, for
  both kernels and torch.matmul on the dequantised weights;
- a SHA-256 of every output at the parent's decode shapes (at most 8 rows
  and K up to 8192: the decoder's shapes at M 1, 2, 5 and 8, Mistral's at
  M 1 and 8, the ragged decode shapes), for int8_matmul with bf16 x (f32
  and bf16 out) and f32 x and for w8a8_matmul, which the trees must share;
- Mistral's down projection (K 14336, N 4096) at M 8, bf16 x and out:
  both kernels, their plain twins and their library calls (torch.matmul
  on the dequantised bf16 weight; torch._int_mm, x padded to 32 rows).

``--down`` times only the down projection (a short call).

Prints the card's name and power limit, a table of the median of each
tree's runs, whether the outputs at the decode shapes are equal bit for
bit, and the largest M of the sweep up to which the last tree's stream
beat the first tree's route at all five matrices; with ``--report PATH`` it also writes
every run to PATH as JSON.  It needs a card and exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import hashlib
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


SWEEP_M = (1, 8, 16, 24, 32, 40, 48, 64, 96, 128)
KINDS = ("int8_bf16", "int8_f32", "w8a8")


def calls(torch, ops, x, wq, s):
    """The three timed calls on (x, wq, s): int8_matmul with bf16 x (bf16
    out) and f32 x (f32 out), w8a8_matmul (bf16 out)."""
    xb = x.bfloat16()
    xq, sx = ops.quantize_int8_rows(xb)
    return {"int8_bf16": lambda: ops.int8_matmul(xb, wq, s, torch.bfloat16),
            "int8_f32": lambda: ops.int8_matmul(x, wq, s, torch.float32),
            "w8a8": lambda: ops.w8a8_matmul(xq, sx, wq, s, torch.bfloat16)}


def route_of(ops, m, n, k):
    q = ops.quant
    if hasattr(q, "_route"):
        return q._route(m, n, k)
    return "decode" if m <= q.DECODE_M and k <= q.DECODE_K else "prefill"


def decode_hashes(torch, ops, cs):
    """SHA-256 of every output at the parent's decode shapes, from inputs
    of one seed a shape."""
    shapes = [(M, K, N) for M in (1, 2, 5, 8) for K, N in cs.SHAPES.values()]
    shapes += [(M, K, N) for M in (1, 8) for K, N in cs.MISTRAL_SHAPES.values() if K <= 8192]
    shapes += [c[:3] for c in cs.RAGGED + cs.DECODE_RAGGED if c[0] <= 8 and c[1] <= 8192]
    dev = torch.device("cuda")
    out = {}
    for i, (M, K, N) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn((M, K), generator=g, device=dev)
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        xq, sx = ops.quantize_int8_rows(x)
        outs = [ops.int8_matmul(x.bfloat16(), wq, s, out_dtype=torch.float32),
                ops.int8_matmul(x.bfloat16(), wq, s, out_dtype=torch.bfloat16),
                ops.int8_matmul(x, wq, s, out_dtype=torch.float32),
                ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.float32)]
        h = hashlib.sha256()
        for o in outs:
            h.update(o.cpu().view(torch.uint8).numpy().tobytes())
        out[f"M={M} K={K} N={N}"] = h.hexdigest()
    return out


def down_projection(torch, ops, cs, flush):
    """{call: ms} of Mistral's down projection at M 8 (bf16 x, bf16 out):
    int8_matmul and w8a8_matmul, their plain twins and library calls."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    K, N = cs.MISTRAL_SHAPES["down"]
    x = torch.randn((8, K), generator=g, device=dev).to(torch.bfloat16)
    wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
    xq, sx = ops.quantize_int8_rows(x)
    wd = (wq.float() * s).to(torch.bfloat16)
    xl, wl = cs.int_mm_operands(torch, xq, wq)
    bf = torch.bfloat16
    run = {"int8_matmul": lambda: ops.int8_matmul(x, wq, s, out_dtype=bf),
           "int8_matmul_plain": lambda: ops.int8_matmul_plain(x, wq, s, out_dtype=bf),
           "int8_matmul_library": lambda: torch.matmul(x, wd),
           "w8a8_matmul": lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=bf),
           "w8a8_matmul_plain": lambda: ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=bf),
           "w8a8_matmul_library": lambda: torch._int_mm(xl, wl)}
    return {k: cs.event_ms(f, 20, flush) for k, f in run.items()}


def child(tree, down_only=False):
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
    down = down_projection(torch, ops, cs, flush_buf.zero_)
    if down_only:
        print(json.dumps(dict(tree=tree, down=down)))
        return
    shapes = {}
    for M in (1, 2, 5, 8):
        for name, (K, N) in cs.SHAPES.items():
            x = torch.randn((M, K), generator=g, device=dev)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            shapes[f"M={M} {name}"] = {k: cs.event_ms(f, 20, flush_buf.zero_)
                                       for k, f in calls(torch, ops, x, wq, s).items()}
    sweep = {}
    for name, (K, N) in cs.MISTRAL_SHAPES.items():
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        for M in SWEEP_M:
            x = torch.randn((M, K), generator=g, device=dev)
            r = {"route": route_of(ops, M, N, K)}
            r.update({k: cs.event_ms(f, 20, flush_buf.zero_)
                      for k, f in calls(torch, ops, x, wq, s).items()})
            sweep[f"M={M} {name}"] = r
        del wq, s
    step_ms, b_int8, b_w8a8, _ = cs.decode_step_timing(torch, ops)
    layer = ("qkv", "o", "gate_up", "down")
    llama = {}
    for key, M, depth in (("llama_decode_step", 8, cs.LLAMA_SERVE["depth"]),
                          ("verify_forward", 40, cs.SERVE_CFG["depth"])):
        ms, bi, bw, _ = cs.forward_timing(torch, ops, M, cs.MISTRAL_SHAPES, depth, layer, M)
        llama[key] = dict(ms, int8_bound_ms=bi[0], w8a8_bound_ms=bw[0])
        cs.free_card(torch)
    print(json.dumps(dict(tree=tree, down=down, shapes=shapes, sweep=sweep, step=step_ms,
                          step_bound_ms=dict(int8=b_int8[0], w8a8=b_w8a8[0]), llama=llama,
                          hashes=decode_hashes(torch, ops, cs),
                          profile=profile_step(torch, ops, cs))))


def stream_m(med, route, trees, sweep_keys):
    """The largest M of the sweep up to which the last tree's stream beat
    the first tree's route at all five matrices in every kind, counting M
    above 8 only (8 where it never did)."""
    best = 8
    for M in (m for m in SWEEP_M if m > 8):
        for key in (k for k in sweep_keys if k.startswith(f"M={M} ")):
            if route(trees[-1], key) != "stream" or not all(
                    med(trees[-1], lambda r: r["sweep"][key][kind])
                    < med(trees[0], lambda r: r["sweep"][key][kind]) for kind in KINDS):
                return best
        best = M
    return best


def summarise(cs, card, trees, runs):
    """Prints the medians of each tree's runs."""
    by_tree = {t: [r for r in runs if r["tree"] == t] for t in trees}

    def med(tree, get):
        return statistics.median(get(r) for r in by_tree[tree])

    print(card)
    K, N = cs.MISTRAL_SHAPES["down"]
    print(f"the down projection ({K}, {N}) at M 8, bf16 x and out, ms a call (median of each "
          f"tree's runs), L2 flushed: " + " | ".join(trees))
    for kind in runs[0]["down"]:
        print(f"  {kind}: " + " / ".join(f"{med(t, lambda r: r['down'][kind]):.4f}"
                                        for t in trees))
    if "shapes" not in runs[0]:
        return

    def route(tree, key):
        return by_tree[tree][0]["sweep"][key]["route"]

    print("us a call (median of each tree's runs), L2 flushed: " + " | ".join(trees))
    for key in runs[0]["shapes"]:
        cells = []
        for kind in KINDS:
            vals = [med(t, lambda r: r["shapes"][key][kind]) * 1e3 for t in trees]
            cells.append(f"{kind} " + " / ".join(f"{v:.2f}" for v in vals))
        print(f"  {key:10s} " + "; ".join(cells))
    print("Mistral's matrices, us a call on each tree's route (median of each tree's runs): "
          + " | ".join(trees))
    for key in runs[0]["sweep"]:
        cells = []
        for kind in KINDS:
            vals = [f"{med(t, lambda r: r['sweep'][key][kind]) * 1e3:.2f}" for t in trees]
            cells.append(f"{kind} " + " / ".join(vals))
        print(f"  {key:14s} [{'/'.join(route(t, key) for t in trees)}] " + "; ".join(cells))
    print(f"the stream beat {trees[0]}'s route at all five matrices, every kind, up to "
          f"M {stream_m(med, route, trees, list(runs[0]['sweep']))} of the sweep")
    for kind in runs[0]["step"]:
        vals = [med(t, lambda r: r["step"][kind]) for t in trees]
        print(f"step ({cs.PER_FORWARD} calls) {kind}: " + " / ".join(f"{v:.4f}" for v in vals)
              + " ms")
    for key, r0 in runs[0]["llama"].items():
        for kind in r0:
            vals = [med(t, lambda r: r["llama"][key][kind]) for t in trees]
            print(f"{key} (33 calls) {kind}: " + " / ".join(f"{v:.4f}" for v in vals) + " ms")
    first = runs[0]["hashes"]
    differ = sorted({k for r in runs for k in first if r["hashes"].get(k) != first[k]})
    print(f"outputs at the parent's {len(first)} decode shapes bitwise equal across every run: "
          f"{not differ}" + (f"; they differ at {differ}" if differ else ""))
    print("device time by torch.profiler, us (median of each tree's runs):")
    for kind, r0 in runs[0]["profile"].items():
        for key in r0:
            vals = [med(t, lambda r: r["profile"][kind][key]) for t in trees]
            print(f"  {kind} {key}: " + " / ".join(f"{v:.2f}" for v in vals))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    parser.add_argument("--down", action="store_true",
                        help="time only Mistral's down projection at M 8")
    parser.add_argument("--report", metavar="PATH",
                        help="also write every run to PATH as JSON")
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.down)
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("int8_decode_ab: needs a CUDA card and two trees", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    card = cs.card_line()
    order = args.trees + args.trees[::-1]
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree]
                             + ["--down"] * args.down, capture_output=True, text=True, cwd=ROOT)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"timed {tree}", flush=True)
    summarise(cs, card, args.trees, runs)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
