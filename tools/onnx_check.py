#!/usr/bin/env python3
"""Run chip_smoke.py's last slice's phases (45-48) alone on one CUDA card:
ResNet-50 exported to ONNX on the card and run by OnnxModel as one CUDA
graph per batch shape against CompiledEvalStep, served over gRPC Predict
from its file; the bench row's TransformerLM widths at depth 2 exported
and round-tripped, its flash=True twin refused; the viz server training
MNIST_CNN on the card over a WebSocket; nn.torch_function on card
tensors; cpu_native on the card's host (the g++ build, the C entries, the
MLP through the C kernels, a 1024^3 SGEMM against torch.matmul).

    python3 tools/onnx_check.py [--report PATH]

It builds the kernels first (the TransformerLM's reference runs the flash
kernel), prints the card's name and power limit, and exits non-zero
without a card or when a check fails.
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
        print("onnx_check: needs a CUDA card", file=sys.stderr)
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
    report["counts"] = cs.last_slice_phases(torch, dt, report, card)
    print(f"done, {time.perf_counter() - t0:.1f} s from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
