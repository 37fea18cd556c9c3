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
  at M 1536 (a B 8 prefill) and 192 (B 1), and Mistral's five matrices
  (chip_smoke.MISTRAL_SHAPES) at M 1536 (a Llama prefill) and 2048 (an
  engine admission): int8_matmul with bf16 x (bf16 out) and with f32 x
  (f32 out), and w8a8_matmul (bf16 out), one call each, beside
  torch.matmul on the dequantised bf16 weight and torch._int_mm on the
  int8 operands;
- for a tree with the wgmma route (ops/quant.py _prefill_wgmma_plan), the
  bf16-x call at each of those shapes with each wgmma tile forced in turn
  (the sweep the plan's block times are fitted to) and with the "mma"
  route forced (the mma.sync tile); for a tree with w8a8's wgmma route
  (_w8a8_wgmma_plan), the w8a8 call likewise, beside torch._int_mm and
  the call's bound (2 M K N over 1,979 TOPS);
- for a tree with the mma.sync tile (ops/quant.py _prefill_plan), each of
  its tile heights forced in turn at the decoder's shapes (int8 with bf16
  and f32 x, w8a8);
- PERF.md row 5p's three entries (chip_smoke.forward_timing): one
  prefill's 49 calls (48 at M 1536 over 12 layers of distinct weights and
  the head at M 8), a Llama prefill's 33 at M 1536 (Mistral's widths,
  depth 8, the head at M 8) and an engine admission's 33 at M 2048 (the
  head at M 1), with the plain twins and library calls beside them; and,
  to show the decode path unchanged, one decode step's 49 calls;
- a SHA-256 of the outputs that must not move, which the trees must
  share: at the decode shapes of tools/int8_decode_ab.py (decode_hashes),
  at the stream's shapes (Mistral's five matrices at M 16 to 48, the down
  projection at M 1 and 8, chip_smoke.stream_ragged) for int8_matmul with
  bf16 and f32 x and w8a8_matmul, and at the prefill shapes above for
  w8a8_matmul (its exact sums give the same bits on any route) and
  int8_matmul with f32 x (the mma.sync tile) and with bf16 x (the wgmma
  route).

Prints the card's name and power limit and a table of the median of each
tree's runs; with ``--report PATH`` it also writes every run to PATH as
JSON.  It needs a card and exits non-zero without one, and when a
digest differs between runs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from int8_decode_ab import ROOT, decode_hashes, load_chip_smoke  # noqa: E402

KINDS = ("int8_bf16", "int8_f32", "w8a8", "matmul", "int_mm")


def prefill_shapes(cs):
    """(label, M, K, N) of every timed prefill shape."""
    out = [(f"M={M} {name}", M, *cs.SHAPES[name]) for M in (cs.PREFILL_M, cs.MODEL["max_len"])
           for name in ("qkv", "o", "fc1", "fc2")]
    return out + [(f"M={M} Mistral {name}", M, K, N) for M in (cs.PREFILL_M, cs.SERVING_M[1])
                  for name, (K, N) in cs.MISTRAL_SHAPES.items()]


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


def digest(torch, outs):
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def fixed_hashes(torch, ops, cs):
    """{route: {shape: SHA-256}} of the outputs the wgmma route must leave
    as they were: the decode shapes (int8_decode_ab.decode_hashes), the
    stream's shapes (int8_matmul with bf16 x, f32 and bf16 out, and f32 x;
    w8a8_matmul) and the prefill shapes' w8a8_matmul and int8_matmul with
    f32 and bf16 x."""
    dev = torch.device("cuda")
    stream = [(M, K, N) for M in (16, 24, 32, 40, 48) for K, N in cs.MISTRAL_SHAPES.values()]
    stream += [(M, *cs.MISTRAL_SHAPES["down"]) for M in (1, 8)]
    stream += [c[:3] for c in cs.stream_ragged(48)]
    prefill = [(M, K, N) for _, M, K, N in prefill_shapes(cs)]
    out = {"decode": decode_hashes(torch, ops, cs), "stream": {}, "prefill": {}}
    for kind, shapes in (("stream", stream), ("prefill", prefill)):
        for i, (M, K, N) in enumerate(shapes):
            g = torch.Generator(device=dev).manual_seed(300 + i)
            x = torch.randn((M, K), generator=g, device=dev)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            xq, sx = ops.quantize_int8_rows(x)
            outs = [ops.int8_matmul(x, wq, s, out_dtype=torch.float32),
                    ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.bfloat16)]
            if kind == "prefill":
                outs.append(ops.int8_matmul(x.bfloat16(), wq, s, out_dtype=torch.bfloat16))
            if kind == "stream":
                outs += [ops.int8_matmul(x.bfloat16(), wq, s, out_dtype=torch.float32),
                         ops.int8_matmul(x.bfloat16(), wq, s, out_dtype=torch.bfloat16)]
            out[kind][f"M={M} K={K} N={N}"] = digest(torch, outs)
            del x, wq, s, xq, sx
        cs.free_card(torch)
    return out


def forced(quant, name, value, fn):
    """fn() with quant.<name> replaced by value."""
    saved = getattr(quant, name)
    setattr(quant, name, value)
    try:
        return fn()
    finally:
        setattr(quant, name, saved)


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

    def ms(fn):
        return cs.event_ms(fn, 20, flush_buf.zero_)

    shapes, tiles, wgmma, w8a8 = {}, {}, {}, {}
    has_wgmma = hasattr(quant, "_prefill_wgmma_plan")
    has_w8a8 = hasattr(quant, "_w8a8_wgmma_plan")
    for key, M, K, N in prefill_shapes(cs):
        x = torch.randn((M, K), generator=g, device=dev)
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        runs = shape_runs(torch, ops, cs, x, wq, s)
        shapes[key] = {k: ms(f) for k, f in runs.items()}
        if has_wgmma:
            w = wgmma[key] = {"plan": "%dx%d" % quant._prefill_wgmma_plan(M, N, K)}
            for tile in quant._WGMMA_TILES:
                w["%dx%d" % tile] = forced(quant, "_prefill_wgmma_plan",
                                           lambda *a, t=tile: t, lambda: ms(runs["int8_bf16"]))
            w["mma"] = forced(quant, "_prefill_route", lambda *a: "mma",
                              lambda: ms(runs["int8_bf16"]))
        if has_w8a8:
            w = w8a8[key] = {"plan": "%dx%d" % quant._w8a8_wgmma_plan(M, N, K),
                             "bound": cs.bound_ms(M * K + 4 * M + K * N + 4 * N + 2 * M * N,
                                                  2 * M * K * N, "int8")[0]}
            for tile in quant._W8A8_TILES:
                w["%dx%d" % tile] = forced(quant, "_w8a8_wgmma_plan",
                                           lambda *a, t=tile: t, lambda: ms(runs["w8a8"]))
            w["mma"] = forced(quant, "_w8a8_prefill_route", lambda *a: "mma",
                              lambda: ms(runs["w8a8"]))
        if "Mistral" not in key and hasattr(quant, "_prefill_plan"):
            t = tiles[key] = {"plan": quant._prefill_plan(M, N, K)[0]}
            for tile_m in quant._PREFILL_MS:
                t[tile_m] = forced(quant, "_prefill_plan",
                                   lambda *a, tm=tile_m: (tm, quant._PREFILL_N),
                                   lambda: {k: ms(runs[k]) for k in KINDS[:3]})
        del x, wq, s, runs
        cs.free_card(torch)
    layer = ("qkv", "o", "gate_up", "down")
    forwards = {}
    for key, args in (("prefill", (cs.PREFILL_M,)),
                      ("llama_prefill", (cs.PREFILL_M, cs.MISTRAL_SHAPES,
                                         cs.LLAMA_SERVE["depth"], layer)),
                      ("admission_prefill", (cs.SERVING_M[1], cs.MISTRAL_SHAPES,
                                             cs.SERVE_CFG["depth"], layer, 1)),
                      ("decode_step", (8,))):
        t, b_int8, b_w8a8, _ = cs.forward_timing(torch, ops, *args)
        forwards[key] = dict(t, int8_bound_ms=b_int8[0], w8a8_bound_ms=b_w8a8[0])
        cs.free_card(torch)
    print(json.dumps(dict(tree=tree, shapes=shapes, wgmma=wgmma, w8a8=w8a8, tiles=tiles,
                          forwards=forwards, hashes=fixed_hashes(torch, ops, cs))))


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
        print(f"  {key:18s} " + "; ".join(cells))
    for tree in args.trees:
        sweep = by_tree[tree][0]["wgmma"]
        if sweep:
            print(f"wgmma tiles of {tree}, bf16 x, us a call (* the plan's), and the mma route "
                  "forced:")
            for key, w in sweep.items():
                cells = [("*" if w["plan"] == t else " ") + f"{t} "
                         f"{med(tree, lambda r: r['wgmma'][key][t]) * 1e3:.2f}"
                         for t in w if t not in ("plan", "mma")]
                print(f"  {key:18s} " + "; ".join(cells)
                      + f"; mma {med(tree, lambda r: r['wgmma'][key]['mma']) * 1e3:.2f}")
        sweep = by_tree[tree][0].get("w8a8")
        if sweep:
            print(f"w8a8 wgmma tiles of {tree}, us a call (* the plan's), the mma route forced, "
                  "torch._int_mm and the bound:")
            for key, w in sweep.items():
                cells = [("*" if w["plan"] == t else " ") + f"{t} "
                         f"{med(tree, lambda r: r['w8a8'][key][t]) * 1e3:.2f}"
                         for t in w if t not in ("plan", "mma", "bound")]
                print(f"  {key:18s} " + "; ".join(cells)
                      + f"; mma {med(tree, lambda r: r['w8a8'][key]['mma']) * 1e3:.2f}"
                      + f"; _int_mm {med(tree, lambda r: r['shapes'][key]['int_mm']) * 1e3:.2f}"
                      + f"; bound {w['bound'] * 1e3:.2f}")
        tiles = by_tree[tree][0]["tiles"]
        if tiles:
            print(f"mma.sync tile sweep of {tree}, us a call (int8 bf16 x / int8 f32 x / "
                  "w8a8), * the plan's tile:")
            for key, t0 in tiles.items():
                cells = []
                for tm in t0:
                    if tm == "plan":
                        continue
                    vals = [med(tree, lambda r: r["tiles"][key][tm][k]) * 1e3
                            for k in KINDS[:3]]
                    mark = "*" if str(t0["plan"]) == tm else " "
                    cells.append(f"{mark}BM {tm}: " + " / ".join(f"{v:.2f}" for v in vals))
                print(f"  {key:18s} " + "; ".join(cells))
    for what, r0 in runs[0]["forwards"].items():
        for kind in r0:
            vals = [med(t, lambda r: r["forwards"][what][kind]) for t in args.trees]
            print(f"{what} {kind}: " + " / ".join(f"{v:.4f}" for v in vals) + " ms")
    moved = 0
    for route, first in runs[0]["hashes"].items():
        differ = sorted({k for r in runs for k in first if r["hashes"][route].get(k) != first[k]})
        moved += len(differ)
        print(f"{route} outputs at {len(first)} shapes bitwise equal across every run: "
              f"{not differ}" + (f"; they differ at {differ}" if differ else ""))
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
