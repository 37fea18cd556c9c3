"""Model metadata registry (counterpart of ``deepflows_tpu/utils/model_configs.py``,
its data copied as is)."""

from __future__ import annotations

from typing import Dict, Optional

MODEL_METADATA = {
    "resnet18": {
        "num_classes": 1000,
        "input_size": (3, 224, 224),
        "blocks": [2, 2, 2, 2],
        "family": "resnet",
        "params_millions": 11.7,
    },
    "resnet50": {
        "num_classes": 1000,
        "input_size": (3, 224, 224),
        "blocks": [3, 4, 6, 3],
        "family": "resnet",
        "bottleneck": True,
        "params_millions": 25.6,
    },
    "mobilenet_v1": {
        "num_classes": 1000,
        "input_size": (3, 224, 224),
        "family": "mobilenet",
        "width_multiplier": 1.0,
        "params_millions": 4.2,
    },
    "vgg16": {
        "num_classes": 1000,
        "input_size": (3, 224, 224),
        "family": "vgg",
        "params_millions": 138.4,
    },
}

RESNET_BLOCK_CONFIG = {
    "resnet18": [2, 2, 2, 2],
    "resnet34": [3, 4, 6, 3],
    "resnet50": [3, 4, 6, 3],
}

VGG_CONFIG = {
    # torchvision 'D' configuration for vgg16
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
}

MOBILENET_V1_CONFIG = {
    # (out_channels, stride) per depthwise-separable block after the stem
    "blocks": [
        (64, 1),
        (128, 2),
        (128, 1),
        (256, 2),
        (256, 1),
        (512, 2),
        (512, 1),
        (512, 1),
        (512, 1),
        (512, 1),
        (512, 1),
        (1024, 2),
        (1024, 1),
    ],
}

IMAGENET_STATS = {
    "mean": [0.485, 0.456, 0.406],
    "std": [0.229, 0.224, 0.225],
}


def get_model_metadata(model_name: str) -> Optional[Dict]:
    return MODEL_METADATA.get(model_name)


def is_model_supported(model_name: str) -> bool:
    return model_name in MODEL_METADATA


def get_model_config(model_name: str) -> Optional[Dict]:
    meta = MODEL_METADATA.get(model_name)
    if meta is None:
        return None
    cfg = dict(meta)
    if meta["family"] == "resnet":
        cfg["block_config"] = RESNET_BLOCK_CONFIG.get(model_name)
    elif meta["family"] == "vgg":
        cfg["layer_config"] = VGG_CONFIG.get(model_name)
    elif meta["family"] == "mobilenet":
        cfg["block_config"] = MOBILENET_V1_CONFIG["blocks"]
    return cfg


def get_normalization_stats():
    return IMAGENET_STATS
