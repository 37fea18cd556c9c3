#!/usr/bin/env python3
"""Run chip_smoke.py's CNN phases alone on one CUDA card: ResNet-50 trained
at bench.py's row (10 classes, 224 x 224, B 128, bf16 compute, fused Adam)
and evaluated in f32 and bf16, NF-ResNet-50, ResNet-50 with remat against a
twin without it, MobileNetV1/V2, VGG16-BN and ViT_Tiny for 2 steps each,
CIFAR10_CNN eagerly under use_pallas, and a ResNet-18 SGD step against a
CPU copy, each with its launch counts, and fused_adam and linear_fused
against their plain twins at each path's shapes.

    python3 tools/cnn_family_check.py [--report PATH]

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
        print("cnn_family_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch.ops import _build

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    report = {"card": card, "torch": torch.__version__}
    report["counts"], _ = cs.cnn_phases(
        torch, dt, report, lambda title: print(f"[{time.perf_counter() - t0:.1f} s] {title}"),
        card)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
