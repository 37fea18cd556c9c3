#!/usr/bin/env python3
"""The losses of the CNN paths that chip_smoke.py trains beside ResNet-50
(NF-ResNet-50, MobileNetV1/V2, VGG16-BN, ViT_Tiny at bench.py's shapes,
bf16 compute, fused Adam with weight decay 5e-4) over a few steps on the
repeated batch at each of several learning rates, on one CUDA card: the
sweep that chose the lr of each path.

    python3 tools/cnn_lr_sweep.py [--steps 3] [--lr 5e-3 1e-4 ...]

It builds the kernels first and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

from int8_decode_ab import ROOT, load_chip_smoke

LRS = (5e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 1e-6)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--lr", type=float, nargs="+", default=LRS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cnn_lr_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch.ops import _build

    cs = load_chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    _build.build_all()
    runs = [("nf_resnet50", "ResNet50", dict(num_classes=cs.CNN_CLASSES, norm="free"),
             cs.CNN_B, cs.CNN_IMAGE, cs.CNN_LR)] + list(cs.CNN_FAMILY)
    for name, cls, kw, B, image, chosen in runs:
        x, y = cs.cnn_batch(B, image)
        for lr in args.lr:
            model = cs.cnn_model(dt, cls, **kw)
            step = cs.cnn_step(torch, model, dict(cs.ADAM, lr=lr))
            losses = [float(step(x, y)) for _ in range(args.steps)]
            print(f"{name} (B {B}, {image} x {image}) lr {lr:g}: losses {losses}; "
                  f"{'falls' if losses[-1] < losses[0] else 'does not fall'}"
                  + (" (chip_smoke.py's lr)" if lr == chosen else ""), flush=True)
            del step, model
            cs.free_card(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
