"""Pretrained-weight conversion CLI (counterpart of
``deepflows_tpu/utils/convert_pretrained.py``)::

    python -m deepflows_tpu_torch.utils.convert_pretrained \
        --model_name resnet18 --source pytorch \
        [--weights_path /path/to/resnet18.pth] [--pretrained_dir DIR]
    python -m deepflows_tpu_torch.utils.convert_pretrained --list
"""

from __future__ import annotations

import argparse
import logging

from .pretrained_models import (
    DEFAULT_PRETRAINED_DIR,
    SUPPORTED_MODELS,
    convert_weights_to_deepflows,
    download_pretrained_model,
    is_pretrained_available,
    list_available_pretrained_models,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Convert pretrained weights")
    parser.add_argument("--model_name", choices=SUPPORTED_MODELS)
    parser.add_argument("--source", default="pytorch", choices=["pytorch"])
    parser.add_argument("--weights_path", default=None,
                        help="local torch .pth; downloaded via torchvision when omitted")
    parser.add_argument("--pretrained_dir", default=DEFAULT_PRETRAINED_DIR)
    parser.add_argument("--list", action="store_true", help="list models and exit")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.list:
        downloaded = set(list_available_pretrained_models(True, args.pretrained_dir))
        for m in SUPPORTED_MODELS:
            print(f"{m:15s} {'[converted]' if m in downloaded else ''}")
        return 0

    if not args.model_name:
        parser.error("--model_name is required unless --list")
    path = args.weights_path or download_pretrained_model(
        args.model_name, pretrained_dir=args.pretrained_dir)
    out = convert_weights_to_deepflows(args.model_name, path, args.pretrained_dir)
    print(f"converted -> {out}")
    if not is_pretrained_available(args.model_name, args.pretrained_dir):
        raise RuntimeError(f"no converted file at {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
