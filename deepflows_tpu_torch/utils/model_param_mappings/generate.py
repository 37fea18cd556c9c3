"""Regenerate the torchvision -> port name-mapping JSONs from the port's
zoo (the same files as ``deepflows_tpu/utils/model_param_mappings``).

The zoo keeps torchvision's module names (ResNet: conv1 / bn1 /
layerN.M.* / fc; VGG16: features.N / classifier.N, ReLU and Dropout in
the same slots), so every mapping is the identity over the model's
parameter and buffer names, with torch's ``num_batches_tracked`` buffers
listed too (the converter drops them).  MobileNetV1 has no torchvision
counterpart: its mapping is the identity.  MobileNetV2's names torch's
anonymous ConvBNActivation ``Sequential`` (conv at 0, bn at 1) where the
zoo names ``conv`` and ``bn``.

    python -m deepflows_tpu_torch.utils.model_param_mappings.generate
"""

from __future__ import annotations

import json
import os


def _names(model):
    return [name for name, _ in model.named_parameters()] + [
        name for name, _ in model.named_buffers()
    ]


def build_mapping(model) -> dict:
    mapping = {}
    for name in _names(model):
        mapping[name] = name
        if name.endswith("running_var"):
            nb = name.rsplit(".", 1)[0] + ".num_batches_tracked"
            mapping[nb] = nb  # torch-only; dropped by the converter
    return mapping


def build_mobilenet_v2_mapping(model) -> dict:
    """torchvision-name -> port-name mapping of MobileNetV2: only the names
    inside each ConvBNReLU differ."""
    from deepflows_tpu_torch.models.mobilenet import ConvBNReLU

    cbr_paths = {path for path, m in model.named_modules() if isinstance(m, ConvBNReLU)}

    def to_torch(name: str) -> str:
        for p in cbr_paths:
            if name.startswith(p + "."):
                rest = name[len(p) + 1:]
                if rest.startswith("conv."):
                    return f"{p}.0.{rest[len('conv.'):]}"
                if rest.startswith("bn."):
                    return f"{p}.1.{rest[len('bn.'):]}"
        return name

    mapping = {}
    for name in _names(model):
        mapping[to_torch(name)] = name
        if name.endswith("running_var"):
            nb = name.rsplit(".", 1)[0] + ".num_batches_tracked"
            mapping[to_torch(nb)] = nb
    return mapping


def main() -> None:
    from deepflows_tpu_torch import models

    zoo = {
        "resnet18": models.ResNet18(device="cpu"),
        "resnet50": models.ResNet50(device="cpu"),
        "vgg16": models.VGG16(device="cpu"),
        "mobilenet_v1": models.MobileNetV1(device="cpu"),
    }
    here = os.path.dirname(os.path.abspath(__file__))
    for name, model in zoo.items():
        path = os.path.join(here, f"{name}_complete_mapping.json")
        with open(path, "w") as f:
            json.dump(build_mapping(model), f, indent=2, sort_keys=True)
        print(f"wrote {path}")
    v2 = models.MobileNetV2(device="cpu")
    path = os.path.join(here, "mobilenet_v2_complete_mapping.json")
    with open(path, "w") as f:
        json.dump(build_mobilenet_v2_mapping(v2), f, indent=2, sort_keys=True)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
