from .convert import load_jax_optimizer_state, load_jax_state_dict
from .evaluate import Accumulator, accuracy, evaluate_accuracy, softmax, topk_accuracy
from .model_configs import (
    IMAGENET_STATS,
    MOBILENET_V1_CONFIG,
    MODEL_METADATA,
    RESNET_BLOCK_CONFIG,
    VGG_CONFIG,
    get_model_config,
    get_model_metadata,
    get_normalization_stats,
    is_model_supported,
)
from .model_utils import AsyncCheckpointer, load_checkpoint, save_checkpoint

__all__ = [
    "Accumulator",
    "AsyncCheckpointer",
    "IMAGENET_STATS",
    "MOBILENET_V1_CONFIG",
    "MODEL_METADATA",
    "RESNET_BLOCK_CONFIG",
    "VGG_CONFIG",
    "accuracy",
    "evaluate_accuracy",
    "get_model_config",
    "get_model_metadata",
    "get_normalization_stats",
    "is_model_supported",
    "load_checkpoint",
    "load_jax_optimizer_state",
    "load_jax_state_dict",
    "save_checkpoint",
    "softmax",
    "topk_accuracy",
]
