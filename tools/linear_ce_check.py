#!/usr/bin/env python3
"""A short first check of linear_fused / matmul and of the bf16
fused_linear_ce forward and backward on one CUDA card.

    python3 tools/linear_ce_check.py [linear] [large] [fwd] [ce]

Builds the kernels (printing ptxas's registers, shared memory, spills and
warnings for linear_f32.cu and fused_linear_ce.cu), then, for each part
named (all by default):

- linear: matmul and linear_fused (every activation) against their plain
  twins at rtol 1e-4 / atol 1e-3 (chip_smoke.mm_check) at the MLP's
  layers and backward products, transposed views, the plan's split edges
  (K 8, 9, 16, 17, 784 and 4095 at a small M·N) and 4096^3; two MLP layer-1 calls
  bitwise equal; MLP layer 1 timed beside torch.addmm.
- large: the 128 x 128 tile (chip_smoke.large_tile_checks): ragged
  products in every operand layout and each epilogue, and 4096^3 bitwise
  equal to the small tile with one split; 4096^3 timed beside
  torch.matmul.
- fwd: the bf16 forward (chip_smoke.ce_fwd_checks) on every route it must
  take, two slice-shape calls bitwise equal and its planted fault; the
  slice shape timed beside its library pair.
- ce: the bf16 backward against its plain twin by row and by column
  (chip_smoke.ce_case) at the slice's shape and at D 200, 256, 257, 1000,
  2048 and 4096; two slice-shape calls bitwise equal; the slice shape
  timed beside its library pair.

It is the quick call to make after a change to those kernels, before
chip_smoke.py's full run.  Prints where a case disagrees and exits
non-zero on a disagreement and without a card.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_K = (8, 9, 16, 17, 784, 4095)  # the linear plan's split edges, at (64, K, 48)


def linear_checks(torch, ops, cs):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bad = 0
    shapes = cs.MLP_SHAPES + cs.MM_SHAPES + tuple((64, k, 48) for k in EDGE_K)
    for m, k, n in shapes + ((4096, 4096, 4096),):
        a, b = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n)))
        bias = torch.randn((1, n), generator=g, device=dev)
        cases = [(f"matmul {(m, k, n)}", lambda: ops.matmul(a, b), lambda: ops.matmul_plain(a, b)),
                 (f"matmul {(m, k, n)} a^T", lambda: ops.matmul(a.t().contiguous().t(), b),
                  lambda: ops.matmul_plain(a, b))]
        cases += [(f"linear_fused {(m, k, n)} {act}",
                   lambda act=act: ops.linear_fused(a, b, bias, act),
                   lambda act=act: ops.linear_fused_plain(a, b, bias, act))
                  for act in ops.linear.ACTIVATIONS]
        for label, kern, plain in cases:
            try:
                cs.mm_check(kern(), plain(), label)
            except SystemExit as e:
                bad += 1
                print(e, flush=True)
    for m, k, n in cs.MLP_SHAPES:  # the bias-free MLP's backward products
        x, w, gy = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (m, n)))
        for label, kern, plain in ((f"dW {(k, n)}", lambda: ops.matmul(x.t(), gy),
                                    lambda: ops.matmul_plain(x.t(), gy)),
                                   (f"dx {(m, k)}", lambda: ops.matmul(gy, w.t()),
                                    lambda: ops.matmul_plain(gy, w.t()))):
            try:
                cs.mm_check(kern(), plain(), label)
            except SystemExit as e:
                bad += 1
                print(e, flush=True)
    m, k, n = cs.MLP_SHAPES[0]
    x, w, bias = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (1, n)))
    same = torch.equal(ops.linear_fused(x, w, bias), ops.linear_fused(x, w, bias))
    bad += not same
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    t = {name: cs.event_ms(f, 20, flush.zero_) for name, f in dict(
        linear_fused=lambda: ops.linear_fused(x, w, bias),
        addmm=lambda: torch.addmm(bias, x, w)).items()}
    torch.cuda.synchronize()
    print(f"linear: {len(shapes) + 1} shapes and the MLP's backward products checked, "
          f"{bad} disagree; two MLP layer-1 calls bitwise equal: {same}; MLP layer 1 ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    return bad


def large_checks(torch, ops, cs):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    try:
        err, same = cs.large_tile_checks(torch, ops, g)
    except SystemExit as e:
        print(e, flush=True)
        return 1
    a, b = (torch.randn((4096, 4096), generator=g, device=dev) for _ in range(2))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    t = {name: cs.event_ms(f, 5, flush.zero_) for name, f in dict(
        matmul=lambda: ops.matmul(a, b), torch_matmul=lambda: torch.matmul(a, b)).items()}
    print(f"large: every case agrees, max abs err {err}; 4096^3 bitwise equal to the small tile "
          f"with one split: {same}; 4096^3 ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()),
          flush=True)
    return 0


def fwd_checks(torch, ops, cs):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    try:
        (x, w, b, t), _, errs = cs.ce_fwd_case(torch, ops, g, 8192, 1024, 8192, "bf16",
                                               "contiguous", "wgmma", "slice")
        t = t.clamp(0, 8191)  # F.cross_entropy takes no target outside [0, V)
        out = cs.ce_fwd_checks(torch, ops, g, (x, w, b, t))
    except (SystemExit, RuntimeError) as e:
        print(e, flush=True)
        return 1
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = {name: cs.event_ms(f, 10, flush.zero_) for name, f in dict(
        kernel=lambda: ops.fused_linear_ce_fwd(x, w, b, t),
        library=lambda: F.cross_entropy((torch.matmul(x, w) + b).float(), t,
                                        reduction="none")).items()}
    print(f"fwd: slice {errs}; {out}; slice-shape forward ms {ms}, plan "
          f"{ops.fused_ce._fwd_plan(8192, 8192, 'wgmma')}", flush=True)
    return 0


CE_SHAPES = ((8192, 1024, 8192), (300, 200, 1000), (300, 256, 1000), (300, 257, 1000),
             (300, 1000, 1000), (300, 2048, 1000), (300, 4096, 1000))


def ce_checks(torch, ops, cs):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    bad = 0
    for n, d, v in CE_SHAPES:
        try:
            ops_, want, errs = cs.ce_case(torch, ops, g, n, d, v, torch.bfloat16, torch.bfloat16,
                                          f"{(n, d, v)}")
            print("ok", (n, d, v), ops.fused_ce._bwd_plan(n, d, v),
                  ", ".join(f"{k} {r:.3g}" for k, (r, _) in errs.items()), flush=True)
            if (n, d, v) == CE_SHAPES[0]:
                x, w, b, t, lse, gr = ops_
                same = all(torch.equal(p, q) for p, q in zip(
                    ops.fused_linear_ce_bwd(x, w, b, t, lse, gr),
                    ops.fused_linear_ce_bwd(x, w, b, t, lse, gr)))
                bad += not same
                print("two slice-shape calls bitwise equal:", same,
                      "planted faults:", cs.ce_planted_faults(ops, ops_, want), flush=True)
                flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
                xr, wr, br = (a.detach().requires_grad_() for a in (x, w, b))
                # F.cross_entropy refuses ce_case's targets V + 3 and -1: ignore them
                tl = torch.where((t >= 0) & (t < v), t, -100)
                lib = torch.nn.functional.cross_entropy((torch.matmul(xr, wr) + br).float(), tl,
                                                        reduction="none")
                ms = {name: cs.event_ms(f, 5, flush.zero_) for name, f in dict(
                    kernel=lambda: ops.fused_linear_ce_bwd(x, w, b, t, lse, gr),
                    library=lambda: torch.autograd.grad(lib, (xr, wr, br), gr,
                                                        retain_graph=True)).items()}
                print("slice-shape backward ms:", ms, flush=True)
        except SystemExit as e:
            bad += 1
            print(e, flush=True)
        except RuntimeError as e:
            bad += 1
            print(f"fused_linear_ce {(n, d, v)}: {e}", flush=True)
    return bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("linear_ce_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    parts = sys.argv[1:] or ["linear", "large", "fwd", "ce"]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    for stem in ("linear_f32", "fused_linear_ce"):
        log = _build.BUILD / _build.source_hash() / f"{stem}.log"
        for line in log.read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "error",
                                       "warning")):
                print(stem, line.strip()[:200])
    bad = 0
    if "linear" in parts:
        bad += linear_checks(torch, ops, cs)
    if "large" in parts:
        bad += large_checks(torch, ops, cs)
    if "fwd" in parts:
        bad += fwd_checks(torch, ops, cs)
    if "ce" in parts:
        bad += ce_checks(torch, ops, cs)
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
