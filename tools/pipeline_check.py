#!/usr/bin/env python3
"""Run chip_smoke.py's pipeline phase alone on one CUDA card: the training
phase's TransformerLM (d1024 x 12, B 8 x L 1024, bf16 compute, flash,
fused Adam, the CE on f32 logits) split by pipeline_partition() and
trained by PipelinedTrainStep on a one-rank NCCL mesh {pipe: 1} under
GPipe, 1F1B (one stage of 12 blocks) and interleaved 1F1B (12 chunks),
each held to the plain CompiledTrainStep with accum_steps=4 (launches,
losses, weights) and its eval_logits to the plain model's forward.  On a
machine with more than one card it then starts one NCCL rank per card
and holds GPipe, 1F1B and interleaved over {pipe: n} (and GPipe over
{data: 2, pipe: 2} on 4 cards) against the one-card twin with
accum_steps=8; ``--multi-only`` runs that part alone.

    python3 tools/pipeline_check.py [--multi-only] [--report PATH]

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
                        help="the part on more cards alone")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pipeline_check: needs a CUDA card", file=sys.stderr)
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
    report["counts"] = cs.pipeline_phase(torch, dt, report, card, args.multi_only)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
