#!/usr/bin/env python3
"""Run chip_smoke.py's slice phase alone on one CUDA card: the KV-cache
decoder's generate() and generate_beam() replaying captured CUDA graphs in
the dense, int8 and w8a8 modes, held against the eager loop on the card,
with its launch counts and its timing of graph and eager loop.

    python3 tools/decode_graph_check.py [--report PATH]

It builds the kernels first, prints the card's name and power limit, and
exits non-zero without a card or when a check fails.  About two minutes on
an H100, the build included.
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
    parser.add_argument("--report", metavar="PATH", help="write the phase's numbers to PATH")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_graph_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch.ops import _build

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"register_generator_state: {hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    report = {"card": card, "torch": torch.__version__}
    report["counts"] = cs.slice_phase(torch, dt, report)
    print(f"slice phase done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
