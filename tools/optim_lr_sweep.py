#!/usr/bin/env python3
"""The losses of chip_smoke.py's optimizer paths (LlamaLM at Mistral-7B
widths, depth 1, B 1 x L 2048, bf16 compute over f32 masters, 4 steps on
the repeated batch) under each optimizer at several learning rates, on
one CUDA card: the sweep that chose the lr of each path where the JAX
examples give none, or give one at which the loss does not fall.

    python3 tools/optim_lr_sweep.py [--steps 4] [--only adamw lion ...]

It builds the kernels first and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

from int8_decode_ab import ROOT, load_chip_smoke

LRS = {  # the lr of chip_smoke.py's OPTIMIZERS is added to each list
    "adamw": (3e-3, 1e-3, 3e-4, 1e-4),
    "muon": (0.02, 0.01, 3e-3),
    "adafactor": (0.02, 1e-2, 3e-3, 1e-3),
    "lion": (6.7e-4, 3e-4, 1e-4, 3e-5, 1e-5),
    "rmsprop": (1e-2, 1e-3, 1e-4, 1e-5),
    "adagrad": (1e-2, 3e-3, 1e-3, 1e-4),
    "adadelta": (10.0, 1.0, 0.1),
    "adam_fused": (3e-3, 1e-3, 3e-4, 1e-4),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--only", nargs="+", default=sorted(LRS))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("optim_lr_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import LlamaLM
    from deepflows_tpu_torch.ops import _build

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    _build.build_all()
    cfg = cs.OPT_CFG
    lm = cs.family_model(torch, dt, LlamaLM, cfg, 6, serve=False)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    x, y = cs.ft_batch(torch, 1, cfg["max_len"], cfg["vocab_size"], 6)
    for name, cls, kw in cs.OPTIMIZERS:
        if name not in args.only:
            continue
        for lr in sorted(set(LRS[name]) | {kw["lr"]}, reverse=True):
            lm.load_state_dict(start)
            extra = dict(kw, lr=lr)
            if cls == "Muon":  # the AdamW side keeps the example's 3e-3
                extra["adamw_lr"] = kw["adamw_lr"]
            opt = getattr(optim, cls)(lm.parameters(), **extra)
            step = CompiledTrainStep(lm, opt, nn.CrossEntropyLoss(),
                                     compute_dtype=torch.bfloat16)
            losses = [float(step(x, y)) for _ in range(args.steps)]
            print(f"{name} lr {lr:g}: losses {losses}; "
                  f"{'falls' if losses[-1] < losses[0] else 'does not fall'}"
                  + (" (chip_smoke.py's lr)" if lr == kw["lr"] else ""), flush=True)
            del step, opt
            cs.free_card(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
