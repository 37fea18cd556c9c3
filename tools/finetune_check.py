#!/usr/bin/env python3
"""Run chip_smoke.py's fine-tuning phases alone on one CUDA card: the
kernels at the LoRA and optimizer paths' shapes, LoRA on LlamaLM at
Mistral-7B widths (AdamW, WarmupCosineLR, clipping, accum_steps) merged and
served dense and int8, its full fine-tune twin, every optimizer on the
Llama family with ModelEMA beside AdamW, one f32 step of each optimizer
against a CPU copy; and ResNet-50 (trained at bench.py's row) folded by
fuse_conv_bn against its unfused eval, the two planted fusion faults and
GroupNorm card against CPU.

    python3 tools/finetune_check.py [--report PATH] [--skip-fusion]

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
    parser.add_argument("--skip-fusion", action="store_true",
                        help="leave out the ResNet-50 fusion and GroupNorm checks")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("finetune_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import ops
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
    max_err = {"int8_matmul": 0.0, "w8a8_matmul": 0.0}
    report["counts"], _ = cs.finetune_phases(torch, dt, ops, report, max_err, phase, card)
    if not args.skip_fusion:
        phase("ResNet-50 training, then evaluation fused by fuse_conv_bn:")
        _, _, model, x = cs.resnet50_train_phase(torch, dt, report, card)
        cs.resnet50_fusion_phase(torch, dt, report, model, x, card)
        del model, x
        cs.free_card(torch)
        phase("fusion's planted faults and GroupNorm:")
        cs.fusion_planted_faults(torch, dt)
        cs.group_norm_check(torch, report)
    report["max_err"] = max_err
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
