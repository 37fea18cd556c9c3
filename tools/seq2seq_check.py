#!/usr/bin/env python3
"""Run chip_smoke.py's seq2seq phases alone on one CUDA card: the
Seq2SeqTransformer at BART-base's widths (d_model 768, 12 heads, FFN 3072,
6 + 6 layers, vocab 50265, source 1024, target 256) trained in f32 with
fused Adam (held bitwise against its plain twin over the model's parameter
list first), checkpointed (save, load, an async save beside the next step)
and served (the bf16 generator from a captured step against its eager
loop, the f32 generator against the tape's greedy, gRPC Generate, Predict
from a ResNet-50 checkpoint file), each main path with its launch counts.

    python3 tools/seq2seq_check.py [--report PATH]

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
        print("seq2seq_check: needs a CUDA card", file=sys.stderr)
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

    def phase(title):
        print(f"[{time.perf_counter() - t0:.1f} s] {title}", flush=True)

    report = {"card": card, "torch": torch.__version__}
    report["counts"], report["fused_adam"] = cs.seq2seq_phases(torch, dt, report, phase, card)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
