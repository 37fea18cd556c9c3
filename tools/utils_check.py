#!/usr/bin/env python3
"""Run chip_smoke.py's utils phases alone on one CUDA card: the repository's
markdown through BPETokenizer, LMDataset and Trainer.fit into the bench
row's TransformerLM (its checkpoint reloaded, greedy text from the graphed
decoder), ResNet-50 through Trainer.fit with augmentation on the prefetch
thread, the pretrained-weight converters on a ResNet-50, an HF Llama at
Mistral-7B widths and GPT-2 small (trained, its CE head on the mma route
at V 50257), each main path with its launch counts.

    python3 tools/utils_check.py [--report PATH]

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
        print("utils_check: needs a CUDA card", file=sys.stderr)
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
    report["counts"], report["gpt2_kernels"] = cs.utils_phases(torch, dt, phase, report, card)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
