"""Pretrained weights (counterpart of ``deepflows_tpu/utils/pretrained_models.py``):
download (through torchvision, which this package does not need), convert
to the port's layout, cache as a pickle of numpy arrays with a metadata
file beside it, and load into a zoo model.  The pickle is the JAX
package's: a file converted by either package loads in the other.

"torch layout" here means torchvision's, not the port's: the port's own
``state_dict()`` keeps the reference's ``(in, out)`` Linear weight and
``(1, out)`` bias, so the conversion still rewrites them:

- names map 1:1 (the zoo keeps torchvision's module names); a per-model
  mapping JSON (``model_param_mappings/``, this package's own copy) can
  rename;
- Linear: torchvision's weight ``(out, in)`` -> ``(in, out)``, bias
  ``(out,)`` -> ``(1, out)``;
- Conv2d bias ``(out,)`` -> ``(1, out, 1, 1)``, Conv1d's -> ``(1, out, 1)``;
- BatchNorm weight, bias, running_mean, running_var ``(C,)`` ->
  ``(1, C, 1, 1)``;
- ``num_batches_tracked`` is dropped.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .convert import load_arrays

logger = logging.getLogger(__name__)

DEFAULT_PRETRAINED_DIR = os.path.join(os.path.expanduser("~"), ".deepflows_tpu", "pretrained")

SUPPORTED_MODELS = ["resnet18", "resnet50", "mobilenet_v1", "mobilenet_v2", "vgg16"]

_MAPPING_DIR = os.path.join(os.path.dirname(__file__), "model_param_mappings")


def list_available_models() -> List[str]:
    return list(SUPPORTED_MODELS)


def load_model_param_mapping(model_name: str) -> Optional[Dict[str, str]]:
    """The torchvision-name -> port-name mapping of a model, or None (the
    identity) when it has no JSON."""
    path = os.path.join(_MAPPING_DIR, f"{model_name}_complete_mapping.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def ensure_pretrained_dir_exists(pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> None:
    os.makedirs(pretrained_dir, exist_ok=True)


def get_pretrained_model_path(model_name: str, pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> str:
    return os.path.join(pretrained_dir, f"{model_name}_deepflows.pkl")


def get_model_info_path(model_name: str, pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> str:
    return os.path.join(pretrained_dir, f"{model_name}_info.json")


def save_model_metadata(model_name: str, metadata: Dict[str, Any],
                        pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> None:
    ensure_pretrained_dir_exists(pretrained_dir)
    with open(get_model_info_path(model_name, pretrained_dir), "w") as f:
        json.dump(metadata, f, indent=2)


def load_model_metadata(model_name: str, pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> Dict[str, Any]:
    path = get_model_info_path(model_name, pretrained_dir)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------------ convert
def _numpy(value) -> np.ndarray:
    """A state dict value (a torch tensor of any dtype and device, or an
    array) as numpy; bf16 is widened to f32."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _adapt_array(name: str, arr: np.ndarray, target_shape,
                 is_linear_weight: bool = False) -> Optional[np.ndarray]:
    """A torchvision-layout array in the port's layout for the same
    parameter, or None.  ``is_linear_weight`` comes from the target (a 2-D
    weight is a Linear's): a square torch Linear weight fits the target
    untransposed, so its shape cannot tell."""
    arr = np.asarray(arr)
    target_shape = tuple(target_shape)
    # Linear weight: torch (out, in) -> (in, out), always, square ones too
    if is_linear_weight and arr.ndim == 2 and arr.T.shape == target_shape:
        return np.ascontiguousarray(arr.T)
    if arr.shape == target_shape:
        return arr
    if arr.ndim == 2 and arr.T.shape == target_shape:
        return np.ascontiguousarray(arr.T)
    # bias and BN vectors: (C,) -> (1, C), (1, C, 1), (1, C, 1, 1)
    if arr.ndim == 1 and int(np.prod(target_shape)) == arr.shape[0]:
        return arr.reshape(target_shape)
    return None


def convert_torch_state_dict(model, torch_state_dict: Dict[str, Any],
                             mapping: Optional[Dict[str, str]] = None) -> Dict[str, np.ndarray]:
    """A torchvision-layout state dict in the port's layout for ``model``:
    ``{name: f32 ndarray}``.  Entries the model lacks, or whose shape no
    rule fits, are skipped and logged."""
    own = model.state_dict()
    out: Dict[str, np.ndarray] = {}
    skipped: List[str] = []
    for tname, value in torch_state_dict.items():
        if tname.endswith("num_batches_tracked"):
            continue
        name = mapping.get(tname, tname) if mapping else tname
        if name not in own:
            skipped.append(tname)
            continue
        arr = _numpy(value)
        target = own[name]
        is_linear_weight = target.dim() == 2 and name.endswith("weight")
        adapted = _adapt_array(name, arr, target.shape, is_linear_weight)
        if adapted is None:
            logger.warning("shape mismatch for %s: torch %s vs model %s — skipped",
                           name, arr.shape, tuple(target.shape))
            skipped.append(tname)
            continue
        out[name] = adapted.astype(np.float32)
    if skipped:
        logger.info("skipped %d entries: %s", len(skipped), skipped[:8])
    return out


def to_torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """One array from the port's layout to torchvision's, by name: a 2-D
    weight transposes back to ``(out, in)``, a ``(1, C, 1, ..)`` vector
    flattens to ``(C,)``.  Optimizer state, shaped as its parameter, goes
    the same way."""
    if arr.ndim == 2 and name.endswith("weight"):
        return np.ascontiguousarray(arr.T)
    if arr.ndim > 1 and arr.shape[0] == 1 and name.split(".")[-1] in (
        "bias", "weight", "running_mean", "running_var",
    ) and 1 in arr.shape:
        if int(np.prod(arr.shape)) == arr.shape[1]:  # only a true vector
            return arr.reshape(arr.shape[1])
    return arr


def export_torch_state_dict(model) -> Dict[str, np.ndarray]:
    """The model's parameters and persistent buffers in torchvision's layout,
    as numpy arrays (bf16 widened to f32)."""
    return {name: to_torch_layout(name, _numpy(t)) for name, t in model.state_dict().items()}


def download_pretrained_model(model_name: str, source: str = None,
                              pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> str:
    """torchvision's ImageNet weights for ``model_name`` saved as a ``.pth``
    in ``pretrained_dir``; raises when torchvision (or the network) is
    missing: pass a local ``.pth`` to ``convert_weights_to_deepflows``."""
    if model_name not in SUPPORTED_MODELS:
        raise ValueError(f"unsupported model {model_name}; choose from {SUPPORTED_MODELS}")
    ensure_pretrained_dir_exists(pretrained_dir)
    try:
        import torchvision.models as tvm
    except ImportError as e:
        raise RuntimeError(
            "torchvision is not available in this environment; obtain a torch "
            f"state_dict for {model_name} out of band and call "
            "convert_weights_to_deepflows(model_name, <path>)"
        ) from e
    factory = {
        "resnet18": lambda: tvm.resnet18(weights="IMAGENET1K_V1"),
        "resnet50": lambda: tvm.resnet50(weights="IMAGENET1K_V1"),
        # torchvision has no MobileNetV1: its V2 is the source for both names
        "mobilenet_v1": lambda: tvm.mobilenet_v2(weights="IMAGENET1K_V1"),
        "mobilenet_v2": lambda: tvm.mobilenet_v2(weights="IMAGENET1K_V1"),
        "vgg16": lambda: tvm.vgg16(weights="IMAGENET1K_V1"),
    }[model_name]
    path = os.path.join(pretrained_dir, f"{model_name}_torch.pth")
    torch.save(factory().state_dict(), path)
    return path


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


def convert_weights_to_deepflows(model_name: str, source_weights_path: str,
                                 pretrained_dir: str = DEFAULT_PRETRAINED_DIR,
                                 source: str = "pytorch") -> str:
    """A torchvision ``.pth`` -> the port's pickle in ``pretrained_dir``, with
    its metadata file; returns the pickle's path.  The target layout comes
    from the zoo model built on the host."""
    ensure_pretrained_dir_exists(pretrained_dir)
    sd = torch.load(source_weights_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = _build_model(model_name, device="cpu")
    converted = convert_torch_state_dict(model, sd, mapping=load_model_param_mapping(model_name))
    out_path = get_pretrained_model_path(model_name, pretrained_dir)
    with open(out_path, "wb") as f:
        pickle.dump(converted, f)
    save_model_metadata(
        model_name,
        {"source": source, "source_path": os.path.abspath(source_weights_path),
         "num_arrays": len(converted)},
        pretrained_dir,
    )
    return out_path


def get_pretrained_weights(model_name: str, pretrained_dir: str = DEFAULT_PRETRAINED_DIR,
                           auto_download: bool = True) -> Dict[str, np.ndarray]:
    """The converted arrays from the cache, downloading and converting them
    first when they are not there and ``auto_download``."""
    path = get_pretrained_model_path(model_name, pretrained_dir)
    if not os.path.exists(path):
        if not auto_download:
            raise FileNotFoundError(path)
        torch_path = download_pretrained_model(model_name, pretrained_dir=pretrained_dir)
        convert_weights_to_deepflows(model_name, torch_path, pretrained_dir)
    with open(path, "rb") as f:
        return pickle.load(f)


def load_pretrained_model(model, model_name: str, pretrained_dir: str = DEFAULT_PRETRAINED_DIR,
                          strict: bool = False):
    """Copy the converted weights into ``model`` on its device; non-strict by
    default (``Module.load_weights``), with ``strict`` a missing or extra
    name or a shape that differs raises."""
    load_arrays(model, get_pretrained_weights(model_name, pretrained_dir), strict=strict)
    return model


def create_model_with_pretrained_weights(model_name: str,
                                         pretrained_dir: str = DEFAULT_PRETRAINED_DIR,
                                         num_classes: int = 1000, device=None):
    """A zoo model on ``device`` (the card by default) with its pretrained
    weights; with another ``num_classes`` the classifier ``fc`` keeps its
    random init."""
    model = _build_model(model_name, num_classes=num_classes, device=device)
    weights = get_pretrained_weights(model_name, pretrained_dir)
    if num_classes != 1000:
        weights = {k: v for k, v in weights.items() if not k.startswith("fc.")}
    model.load_weights(weights)
    return model


def list_available_pretrained_models(only_downloaded: bool = False,
                                     pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> List[str]:
    if not only_downloaded:
        return list(SUPPORTED_MODELS)
    return [m for m in SUPPORTED_MODELS if os.path.exists(get_pretrained_model_path(m, pretrained_dir))]


def is_pretrained_available(model_name: str, pretrained_dir: str = DEFAULT_PRETRAINED_DIR) -> bool:
    return os.path.exists(get_pretrained_model_path(model_name, pretrained_dir))
