from . import functional, init
from .modules import (
    GELU,
    CrossEntropyLoss,
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    LMHeadCrossEntropy,
    Module,
    MultiheadAttention,
    ReLU,
    Sequential,
    Tanh,
)

__all__ = [
    "CrossEntropyLoss",
    "Dropout",
    "Embedding",
    "GELU",
    "LMHeadCrossEntropy",
    "LayerNorm",
    "Linear",
    "Module",
    "MultiheadAttention",
    "ReLU",
    "Sequential",
    "Tanh",
    "functional",
    "init",
]
