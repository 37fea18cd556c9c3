#!/usr/bin/env python3
"""Run chip_smoke.py's serving phases alone on one CUDA card: int8_matmul
and w8a8_matmul at the verify forward's and an admission prefill's rows,
then LlamaLM at Mistral-7B widths (depth 8, max_len 2048, bf16) served by
the in-flight engine (dense and paged cache, prefix caching; dense, int8
and w8a8 weights) to 32 requests from 4 threads, by the speculative
decoder (a layer-skip draft, the target as its own draft, int8, sampled)
and by the gRPC server to concurrent clients, each path with its launch
counts.

    python3 tools/serving_check.py [--report PATH]

It builds the kernels first, prints the card's name and power limit, and
exits non-zero without a card or when a check fails.
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
        print("serving_check: needs a CUDA card", file=sys.stderr)
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

    def phase(title):
        print(f"[{time.perf_counter() - t0:.1f} s] {title}", flush=True)

    report = {"card": card, "torch": torch.__version__}
    max_err = {"int8_matmul": 0.0, "w8a8_matmul": 0.0}
    report["counts"], _ = cs.serving_phases(torch, dt, ops, report, max_err, phase, card)
    report["max_err"] = max_err
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
