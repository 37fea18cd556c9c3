from . import functional, init
from .modules import (
    GELU,
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    Module,
    MultiheadAttention,
    Sequential,
)

__all__ = [
    "Dropout",
    "Embedding",
    "GELU",
    "LayerNorm",
    "Linear",
    "Module",
    "MultiheadAttention",
    "Sequential",
    "functional",
    "init",
]
