#!/usr/bin/env python3
"""A short first check of int8_matmul and w8a8_matmul on one CUDA card.

    python3 tools/int8_prefill_check.py [--orders] [--against TREE]

Builds the kernels (printing ptxas's report of the wgmma kernels, one
line each: registers, spills and any C75xx note that it serialised a
wgmma), holds both kernels against their plain twins with chip_smoke's
tolerances (chip_smoke.compare: w8a8 exact, int8 rtol 1e-4 / atol 1e-3
plus one bf16 ulp for bf16 output) at a few shapes of both paths (tiny
ones, the decoder's at M 1536 and 192, the prefill tile's edges, a
misaligned weight, ragged K, K past the decode path, both wgmma tiles'
ragged edges), each call of both kernels held to its route
(chip_smoke.compare_routed; int8_matmul.routes, w8a8_matmul.routes) and
printed with it, two bf16-x calls bitwise equal on the wgmma route, the s8
wgmma tile at its edges with each tile and the "mma" route forced
(chip_smoke.w8a8_wgmma_checks, with its planted fault), and the stream at
its edges (chip_smoke.stream_checks, with its two-call bitwise check);
then times the decoder's four layer shapes at M 1536 and 192 and
Mistral's five at M 1536 and 2048 (L2 flushed) beside torch.matmul and
torch._int_mm, the bf16-x int8 call and the w8a8 call each with the "mma"
route and each wgmma tile forced (the sweeps quant._WGMMA_TILES and
quant._W8A8_TILES are fitted to), beside w8a8's bound.  It is the quick
call to make after a change to the kernels, before chip_smoke.py's full
run.  Exits non-zero on a disagreement and without a card.

``--orders`` also builds two copies of w8a8_matmul.cu whose s8 wgmma
tile reads its weight rows in one order at every tile (wgp::Fragments
STAGGER): staggered (lane q's load i takes row 4 q + ((i + q) & 3): no
bank conflict) and plain (row 4 q + i: rows i and 8 + i of a warp's load
share a swizzle phase, a 2-way conflict), and times both against the
source at the swept shapes, in turns (source, staggered, plain, plain,
staggered, source) in one process, with their outputs held bitwise to
the source's (ncu, which would count the conflicts, does not run on that
machine).

``--against TREE`` builds TREE's csrc/int8_matmul.cu (another commit's
tree, e.g. an unpacked ``git archive`` of the parent) beside the source's
and times int8_matmul with bf16 x on both at the swept shapes, in turns
(source, TREE, TREE, source) in one process, with the outputs held bitwise
equal: the wgmma route of bf16 x compared with no drift between processes.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (  # (M, K, N, weight 16-byte aligned)
    (16, 32, 8, True), (16, 64, 128, True), (1536, 1024, 3072, True), (192, 1024, 1024, True),
    (1536, 4096, 1024, True), (9, 4096, 1000, True), (129, 4096, 1030, True),
    (300, 4096, 1000, False), (100, 70, 64, True), (40, 33, 100, True), (5, 9000, 48, True),
    (300, 9000, 200, True),
    # the wgmma tile's edges: ragged M, K (not a multiple of 64) and N (not
    # of 128), one tile of 64 rows, K 8
    (49, 4096, 1024, True), (65, 1032, 1040, True), (129, 4104, 208, True),
    (1000, 4096, 1040, True), (300, 9000, 2064, True), (100, 8, 16, True),
)


# The two orders of the s8 fragment reads at every tile, edits of
# csrc/int8_tile.cuh wgp::Fragments<int8_t, NH>
STAGGER_LINE = "static constexpr bool STAGGER = NH == 1;"
ORDERS = {"staggered": "static constexpr bool STAGGER = true;",
          "plain": "static constexpr bool STAGGER = false;"}


def ptxas_lines(log):
    """One line a wgmma instance of a ptxas report: x type, tile, output
    type, registers, spills, and any C75xx note."""
    out = []
    for entry in log.split("ptxas info    : Compiling entry")[1:]:
        m = re.search(r"int8_prefill_wgmmaI(a|13__nv_bfloat16)Li(\d+)ELi(\d)E.*?(Scale\w+?)I(\w+?)E",
                      entry)
        if not m:
            if "C75" in entry:
                out.append(" ".join(entry.split())[:300])
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        notes = sorted(set(re.findall(r"\(C75\d\d\)[^\n]*", entry)))
        out.append(f"wgmma x={'s8' if m.group(1) == 'a' else 'bf16'} BM={m.group(2)} "
                   f"NH={m.group(3)} {m.group(4)}<{m.group(5)}>: "
                   f"{regs.group(1) if regs else '?'} registers, spill "
                   f"{spill.groups() if spill else '?'}, notes {notes or 'none'}")
    return out


def order_copies(build_dir):
    """{order: dft_w8a8_matmul} of copies of the sources with ORDERS'
    edits, built side by side."""
    from deepflows_tpu_torch.ops import _build
    from deepflows_tpu_torch.ops._common import I, P

    text = (_build.CSRC / "int8_tile.cuh").read_text()
    if text.count(STAGGER_LINE) != 1:
        raise SystemExit(f"int8_prefill_check: {STAGGER_LINE!r} does not match once")
    jobs = {}
    for order, line in ORDERS.items():
        d = build_dir / order
        d.mkdir()
        (d / "int8_tile.cuh").write_text(text.replace(STAGGER_LINE, line))
        (d / "w8a8_matmul.cu").write_text((_build.CSRC / "w8a8_matmul.cu").read_text())
        so = d / "libw8a8.so"
        jobs[order] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(d / "w8a8_matmul.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    fns = {}
    for order, (so, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"int8_prefill_check: nvcc failed on the {order} copy")
        fn = ctypes.CDLL(str(so)).dft_w8a8_matmul
        fn.argtypes = [P] * 5 + [I] * 8 + [P]  # as ops/quant.py binds it
        fn.restype = ctypes.c_int
        fns[order] = fn
    return fns


def tree_int8(tree, build_dir):
    """dft_int8_matmul of ``tree``'s csrc/int8_matmul.cu, built with the
    package's flags."""
    from deepflows_tpu_torch.ops import _build
    from deepflows_tpu_torch.ops._common import I, P

    csrc = Path(tree).resolve() / "deepflows_tpu_torch" / "csrc"
    so = build_dir / "libint8_tree.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                    str(csrc / "int8_matmul.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).dft_int8_matmul
    fn.argtypes = [P, I, P, P, P, I, I, I, I, I, I, I, I, P]  # as ops/quant.py binds it
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def int8_from(fn):
    """ops.int8_matmul calls ``fn`` in place of the package's entry."""
    from deepflows_tpu_torch.ops import _build

    intact = _build._functions["dft_int8_matmul"]
    _build._functions["dft_int8_matmul"] = fn
    try:
        yield
    finally:
        _build._functions["dft_int8_matmul"] = intact


def against(torch, ops, cs, tree, cases, g):
    """int8_matmul with bf16 x on the source and on ``tree``'s build at each
    case, in turns, 20 timed calls a turn; prints both medians and fails on
    outputs that differ."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        other = tree_int8(tree, Path(tmp))
    bad, ratios = 0, []
    for M, name, K, N in cases:
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        run = lambda: ops.int8_matmul(x, wq, s)  # noqa: E731
        want = run()
        with int8_from(other):
            if not torch.equal(run(), want):
                bad += 1
                print(f"{tree} M={M} {name}: outputs differ", flush=True)
        t = {"source": [], tree: []}
        for side in ("source", tree, tree, "source"):
            with int8_from(other) if side == tree else contextlib.nullcontext():
                t[side].append(cs.event_ms(run, 20, flush.zero_))
        us = {k: statistics.median(v) * 1e3 for k, v in t.items()}
        ratios.append(us["source"] / us[tree])
        print(f"against M={M} {name} K={K} N={N} tile "
              f"{'%dx%d' % ops.quant._prefill_wgmma_plan(M, N, K)}: source {us['source']:.2f} us, "
              f"{tree} {us[tree]:.2f} us ({100 * (ratios[-1] - 1):+.2f}%)", flush=True)
    print(f"against {tree}: source / tree, median over the cases "
          f"{100 * (statistics.median(ratios) - 1):+.2f}%, range "
          f"{100 * (min(ratios) - 1):+.2f}% to {100 * (max(ratios) - 1):+.2f}%")
    return bad


@contextlib.contextmanager
def w8a8_from(fn):
    """ops.w8a8_matmul calls ``fn`` in place of the package's entry."""
    from deepflows_tpu_torch.ops import _build

    intact = _build._functions["dft_w8a8_matmul"]
    _build._functions["dft_w8a8_matmul"] = fn
    try:
        yield
    finally:
        _build._functions["dft_w8a8_matmul"] = intact


def orders(torch, ops, cs, cases, g):
    """The source against the staggered and plain copies at each case, in
    turns, 20 timed calls a turn; prints each one's median and fails on
    outputs that differ."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        copies = order_copies(Path(tmp))
    bad = 0
    for M, name, K, N in cases:
        xq, sx = ops.quantize_int8_rows(torch.randn((M, K), generator=g, device=dev))
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        run = lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.bfloat16)  # noqa: E731
        want = run()
        for order, fn in copies.items():
            with w8a8_from(fn):
                if not torch.equal(run(), want):
                    bad += 1
                    print(f"{order} order M={M} {name}: outputs differ", flush=True)
        t = {"source": [], "staggered": [], "plain": []}
        for order in ("source", "staggered", "plain", "plain", "staggered", "source"):
            ctx = w8a8_from(copies[order]) if order in copies else contextlib.nullcontext()
            with ctx:
                t[order].append(cs.event_ms(run, 20, flush.zero_))
        us = {k: statistics.median(v) * 1e3 for k, v in t.items()}
        print(f"orders M={M} {name} K={K} N={N} tile "
              f"{'%dx%d' % ops.quant._w8a8_wgmma_plan(M, N, K)}: "
              + ", ".join(f"{k} {v:.2f} us" for k, v in us.items())
              + f" (plain {100 * (us['plain'] / us['staggered'] - 1):+.1f}% on staggered)",
              flush=True)
    return bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_prefill_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    for stem in ("int8_matmul", "w8a8_matmul"):  # each wgmma instance's ptxas report
        for line in ptxas_lines((_build.BUILD / _build.source_hash() / f"{stem}.log").read_text()):
            print(stem, line)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    err = {"int8_matmul": 0.0, "w8a8_matmul": 0.0}
    bad = 0
    for M, K, N, aligned in CASES:
        for xdt in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=g, device=dev).to(xdt)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            if not aligned:
                wq = cs.misaligned(torch, wq)
            try:
                (_, routes), routes8 = cs.routes_taken(ops.w8a8_matmul, lambda: cs.routes_taken(
                    ops.int8_matmul, lambda: cs.compare_routed(
                        torch, ops, x, wq, s, f"M={M} K={K} N={N} aligned={aligned} x={xdt}",
                        err, aligned)))
                print("ok", sorted(set(routes)), "w8a8", sorted(set(routes8)), M, K, N, aligned,
                      xdt, flush=True)
                if routes and routes[0] == "wgmma":
                    a = ops.int8_matmul(x, wq, s)
                    if not torch.equal(a, ops.int8_matmul(x, wq, s)):
                        bad += 1
                        print(f"M={M} K={K} N={N}: two wgmma calls differ", flush=True)
                    plan = ops.quant._prefill_wgmma_plan
                    try:  # every wgmma tile at this shape
                        for tile in ops.quant._WGMMA_TILES:
                            ops.quant._prefill_wgmma_plan = lambda *a, tile=tile: tile
                            for odt in (torch.float32, torch.bfloat16):
                                cs.check_int8(torch, ops.int8_matmul(x, wq, s, out_dtype=odt),
                                              ops.int8_matmul_plain(x, wq, s, out_dtype=odt),
                                              f"tile {tile} M={M} K={K} N={N}")
                    finally:
                        ops.quant._prefill_wgmma_plan = plan
            except SystemExit as e:
                bad += 1
                print(e, flush=True)
    for check in (lambda: cs.w8a8_wgmma_checks(torch, ops, g),
                  lambda: cs.stream_checks(torch, ops, g, err)):
        try:
            check()
        except SystemExit as e:
            bad += 1
            print(e, flush=True)
    torch.cuda.synchronize()
    print("max abs err", err, "cases that disagree", bad)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    mma = ops.quant._prefill_route
    cases = [(M, name, *cs.SHAPES[name]) for M in (cs.PREFILL_M, cs.MODEL["max_len"])
             for name in ("qkv", "o", "fc1", "fc2")]
    cases += [(M, name, K, N) for M in (cs.PREFILL_M, 2048)
              for name, (K, N) in cs.MISTRAL_SHAPES.items()]
    for M, name, K, N in cases:
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        xq, sx = ops.quantize_int8_rows(x)
        wd = (wq.float() * s).bfloat16()
        xf = x.float()
        xl, wl = cs.int_mm_operands(torch, xq, wq)
        t = {k: cs.event_ms(f, 20, flush.zero_) for k, f in dict(
            int8=lambda: ops.int8_matmul(x, wq, s),
            int8_f32=lambda: ops.int8_matmul(xf, wq, s),
            w8a8=lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.bfloat16),
            lib=lambda: torch.matmul(x, wd), int_mm=lambda: torch._int_mm(xl, wl)).items()}
        plan = ops.quant._prefill_wgmma_plan
        try:
            ops.quant._prefill_route = lambda *a: "mma"
            t["int8_mma"] = cs.event_ms(lambda: ops.int8_matmul(x, wq, s), 20, flush.zero_)
            ops.quant._prefill_route = mma
            for tile in ops.quant._WGMMA_TILES:  # each wgmma tile forced
                ops.quant._prefill_wgmma_plan = lambda *a, tile=tile: tile
                t["%dx%d" % tile] = cs.event_ms(lambda: ops.int8_matmul(x, wq, s), 20,
                                                flush.zero_)
        finally:
            ops.quant._prefill_route, ops.quant._prefill_wgmma_plan = mma, plan
        w8 = {}  # w8a8 with each tile, then the mma route, forced
        for tile in list(ops.quant._W8A8_TILES) + ["mma"]:
            with cs.forced_w8a8(ops, tile):
                w8[tile if tile == "mma" else "%dx%d" % tile] = cs.event_ms(
                    lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=torch.bfloat16), 20,
                    flush.zero_)
        bound, _ = cs.bound_ms(M * K + 4 * M + K * N + 4 * N + 2 * M * N, 2 * M * K * N, "int8")
        print(M, name, "plan %dx%d" % plan(M, N, K),
              " ".join(f"{k} {v:.4f}" for k, v in t.items()),
              f"TFLOP/s int8 {2 * M * K * N / t['int8'] / 1e9:.1f}", flush=True)
        print(M, name, "w8a8 plan %dx%d" % ops.quant._w8a8_wgmma_plan(M, N, K),
              " ".join(f"{k} {v:.4f}" for k, v in w8.items()), f"bound {bound:.4f}",
              f"TOPS w8a8 {2 * M * K * N / t['w8a8'] / 1e9:.1f}", flush=True)
    if "--orders" in sys.argv[1:]:
        bad += orders(torch, ops, cs, cases, g)
    if "--against" in sys.argv[1:]:
        bad += against(torch, ops, cs, sys.argv[sys.argv.index("--against") + 1], cases, g)
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
