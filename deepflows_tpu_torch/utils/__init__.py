"""utils (counterpart of ``deepflows_tpu/utils``): the same names where the
JAX package has them, and the port's ``load_jax_state_dict`` and
``load_jax_optimizer_state``."""

from . import data  # noqa: F401
from .convert import load_jax_optimizer_state, load_jax_state_dict
from .evaluate import Accumulator, accuracy, evaluate_accuracy, softmax, topk_accuracy
from .hf_gpt2 import build_gpt2_from_hf_config, convert_hf_gpt2, load_hf_gpt2_state
from .hf_llama import (
    build_llama_from_hf_config,
    build_mixtral_from_hf_config,
    convert_hf_llama,
    convert_hf_mixtral,
    load_hf_llama_state,
    load_hf_mixtral_state,
)
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
from .text import BPETokenizer, LMDataset, SFTDataset
from .trainer import Trainer
from .visual import Animator
from . import profiling  # noqa: E402
from .data import transforms  # noqa: E402

__all__ = [
    "Accumulator",
    "Animator",
    "AsyncCheckpointer",
    "BPETokenizer",
    "IMAGENET_STATS",
    "LMDataset",
    "MOBILENET_V1_CONFIG",
    "MODEL_METADATA",
    "RESNET_BLOCK_CONFIG",
    "SFTDataset",
    "Trainer",
    "VGG_CONFIG",
    "accuracy",
    "build_gpt2_from_hf_config",
    "build_llama_from_hf_config",
    "build_mixtral_from_hf_config",
    "convert_hf_gpt2",
    "convert_hf_llama",
    "convert_hf_mixtral",
    "data",
    "evaluate_accuracy",
    "get_model_config",
    "get_model_metadata",
    "get_normalization_stats",
    "is_model_supported",
    "load_checkpoint",
    "load_hf_gpt2_state",
    "load_hf_llama_state",
    "load_hf_mixtral_state",
    "load_jax_optimizer_state",
    "load_jax_state_dict",
    "profiling",
    "save_checkpoint",
    "softmax",
    "topk_accuracy",
    "transforms",
]
