#!/usr/bin/env python3
"""Run chip_smoke.py's lazy phase (phase 44) alone on one CUDA card: the
reference's loop on models.MLP (a per-step cosine lr) and CIFAR10_CNN
under config.use_pallas in three loops (plain, tape, lazy), the lazy loop
bitwise the plain one with exact launch counts and a template replay a
step; the raw-tape MLP with a changing lr under lazy mode against its
eager loop and a CPU copy; two MLP loops over a dataset held on the card
and sliced a batch a step (f32 Adam, bf16 Lion at a changing lr), lazy
against eager for two epochs; ResNet-50 at 224 (B 64, f32, fused Adam) lazy
against eager tape beside a CompiledTrainStep; the DeepFlows shim under
DEEPFLOWS_LAZY=1.

    python3 tools/lazy_check.py [--report PATH]

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
    parser.add_argument("--report", metavar="PATH", help="write the phase's numbers to PATH")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lazy_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch.ops import _build

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    report = {"card": card, "torch": torch.__version__}
    report["counts"] = cs.lazy_phase(torch, dt, report, card)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
