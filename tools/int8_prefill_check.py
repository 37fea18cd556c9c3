#!/usr/bin/env python3
"""A short first check of int8_matmul and w8a8_matmul on one CUDA card.

    python3 tools/int8_prefill_check.py

Builds the kernels (printing ptxas's report of the wgmma kernels, one
line each: registers, spills and any C75xx note that it serialised a
wgmma), holds both kernels against their plain twins with chip_smoke's
tolerances (chip_smoke.compare: w8a8 exact, int8 rtol 1e-4 / atol 1e-3
plus one bf16 ulp for bf16 output) at a few shapes of both paths (tiny
ones, the decoder's at M 1536 and 192, the prefill tile's edges, a
misaligned weight, ragged K, K past the decode path, the wgmma tile's
ragged edges), printing each case's route (int8_matmul.routes) and where
a case disagrees, two bf16-x calls bitwise equal on the wgmma route, and
the stream at its edges (chip_smoke.stream_checks, with its two-call
bitwise check), then times the decoder's four layer shapes at M 1536 and
192 and Mistral's five at M 1536 and 2048 (bf16 x, L2 flushed) beside
torch.matmul and torch._int_mm, and the bf16-x call with the "mma" route
and each wgmma tile forced.  It is
the quick call to make after a change to the kernels, before
chip_smoke.py's full run.  Exits non-zero on a disagreement and without a
card.
"""

from __future__ import annotations

import os
import sys

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
    for stem in ("int8_matmul", "w8a8_matmul"):  # each kernel's ptxas report, one line
        log = (_build.BUILD / _build.source_hash() / f"{stem}.log").read_text()
        for entry in log.split("ptxas info    : Compiling entry")[1:]:
            if "wgmma" in entry or "C75" in entry:
                print(stem, " ".join(entry.split())[:400])
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
                _, routes = cs.routes_taken(ops.int8_matmul, lambda: cs.compare(
                    torch, ops, x, wq, s, f"M={M} K={K} N={N} aligned={aligned} x={xdt}", err))
                print("ok", sorted(set(routes)), M, K, N, aligned, xdt, flush=True)
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
    try:
        cs.stream_checks(torch, ops, g, err)
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
        print(M, name, "plan %dx%d" % plan(M, N, K),
              " ".join(f"{k} {v:.4f}" for k, v in t.items()),
              f"TFLOP/s int8 {2 * M * K * N / t['int8'] / 1e9:.1f}", flush=True)
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
