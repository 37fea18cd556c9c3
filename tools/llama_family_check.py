#!/usr/bin/env python3
"""Run chip_smoke.py's Llama and Mixtral family phases alone on one CUDA
card: the kernels against their plain twins at the family's shapes, then
Llama serving (Mistral-7B widths, depth 8), streaming past max_len, Llama
training (L 8192, window 4096), Mixtral serving (8x7B widths, depth 2) and
Mixtral training, each with its launch counts.

    python3 tools/llama_family_check.py [--report PATH]

It builds the kernels first, prints the card's name and power limit, and
exits non-zero without a card or when a check fails.  About 150 s on an
H100, the build included.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from int8_decode_ab import ROOT, load_chip_smoke


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", metavar="PATH", help="write the phases' numbers to PATH")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("llama_family_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    report = {"card": card, "torch": torch.__version__}
    report["counts"], _ = cs.family_phases(
        torch, dt, ops, report, {"int8_matmul": 0.0, "w8a8_matmul": 0.0},
        lambda title: print(f"[{time.perf_counter() - t0:.1f} s] {title}"))
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
