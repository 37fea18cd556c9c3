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
    Sequential,
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
    "Sequential",
    "functional",
    "init",
]
