#!/usr/bin/env python3
"""Run chip_smoke.py's tape phase (phase 43) alone on one CUDA card:
matmul and linear_fused against their plain twins at the tape paths'
shapes; the reference's loop (``model(Tensor(x, device="cuda"))``,
criterion, ``zero_grad``, ``backward``, ``step``) on models.MLP and
CIFAR10_CNN under ``config.use_pallas``, each bitwise against its plain
loop with exact launch counts; the raw-tape MLP (8 matmul a step) against
a CPU copy; a reference-style script through ``python -m
deepflows_tpu_torch.shim``; the tape's host cost.

    python3 tools/tape_check.py [--report PATH] [--profile]

``--profile`` then prints cProfile's top functions (by own time) over 10
tape steps and 10 plain steps of the MLP loop: where the tape's host
time goes.

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


def profile_steps(torch, dt, cs, steps=10, top=15):
    """cProfile's top ``top`` functions by own time over ``steps`` MLP steps
    through the tape and as many on plain tensors (use_pallas on)."""
    import cProfile
    import io
    import pstats

    from deepflows_tpu_torch import Graph, Tensor, config, nn, optim
    from deepflows_tpu_torch.models import MLP

    xs, ys = cs.mnist_like()
    dt.manual_seed(0)
    model = MLP(device="cuda")
    opt, crit = optim.Adam(model.parameters(), lr=1e-3), nn.CrossEntropyLoss()

    def tape(i):
        loss = crit(model(Tensor(xs[i], device="cuda")), Tensor(ys[i], device="cuda"))
        opt.zero_grad()
        loss.backward()
        opt.step()
        float(loss.numpy())
        Graph.free_graph_all()

    def plain(i):
        loss = crit(model(torch.as_tensor(xs[i], device="cuda")),
                    torch.as_tensor(ys[i], device="cuda"))
        opt.zero_grad()
        loss.backward()
        opt.step()
        loss.item()

    saved, config.use_pallas = config.use_pallas, True
    try:
        for name, fn in (("tape", tape), ("plain", plain)):
            for i in range(3):
                fn(i)
            prof = cProfile.Profile()
            prof.enable()
            for i in range(steps):
                fn(i)
            prof.disable()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
            print(f"cProfile, {steps} {name} MLP steps:\n{out.getvalue()}")
    finally:
        config.use_pallas = saved


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", metavar="PATH", help="write the phase's numbers to PATH")
    parser.add_argument("--profile", action="store_true",
                        help="cProfile of the MLP loop's tape and plain steps")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tape_check: needs a CUDA card", file=sys.stderr)
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
    t1 = time.perf_counter()
    paths, mm = cs.tape_phase(torch, dt, report, card)
    report["counts"], report["matmul"] = paths, mm
    if args.profile:
        profile_steps(torch, dt, cs)
    print(f"tape phase: {time.perf_counter() - t1:.1f} s; done, {time.perf_counter() - t0:.1f} s "
          f"from the build's start; {card}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
