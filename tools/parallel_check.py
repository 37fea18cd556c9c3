#!/usr/bin/env python3
"""Run chip_smoke.py's parallel phase alone on one CUDA card: a one-rank
NCCL mesh {data: 1, model: 1}; the training phase's TransformerLM (d1024 x
12, B 8 x L 1024, bf16 compute, flash, LMHeadCrossEntropy, fused Adam) by
the plain CompiledTrainStep and by ShardedTrainStep under DP, TP, FSDP +
TP and ZeRO-1, each held to the plain run's launches, losses and weights;
the same model with ring attention; MixtralLM at Mixtral-8x7B widths
(depth 1, L 2048) expert-parallel with MoECriterion.  On a machine with
more than one card it then starts one NCCL rank per card and holds DP,
FSDP and a ring over a model axis of 2 against the one-card plain step;
``--multi-only`` runs the plain step and that part alone.

    python3 tools/parallel_check.py [--multi-only] [--report PATH]

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
    parser.add_argument("--multi-only", action="store_true",
                        help="the plain step and the part on more cards alone")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("parallel_check: needs a CUDA card", file=sys.stderr)
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
    report["counts"] = cs.parallel_phase(torch, dt, report, card, args.multi_only)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
