"""The zoo's builder by name (counterpart of ``_build_model`` in
``deepflows_tpu/utils/pretrained_models.py``); the converters and their
mapping files are still to be ported (ROADMAP.md queue 1)."""

from __future__ import annotations


def _build_model(model_name: str, num_classes: int = 1000, device=None):
    """A zoo model by its checkpoint name, with random weights, on
    ``device`` (the card by default)."""
    from .. import models

    factory = {
        "resnet18": lambda: models.ResNet18(num_classes=num_classes, device=device),
        "resnet50": lambda: models.ResNet50(num_classes=num_classes, device=device),
        "mobilenet_v1": lambda: models.MobileNetV1(num_classes=num_classes, device=device),
        "mobilenet_v2": lambda: models.MobileNetV2(num_classes=num_classes, device=device),
        "vgg16": lambda: models.VGG16(num_classes=num_classes, device=device),
    }
    if model_name not in factory:
        raise ValueError(f"unsupported model {model_name}")
    return factory[model_name]()
