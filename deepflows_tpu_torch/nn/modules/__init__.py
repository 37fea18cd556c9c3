from .activation import GELU
from .attention import MultiheadAttention
from .container import Sequential
from .dropout import Dropout
from .embedding import Embedding
from .linear import Linear
from .module import Module
from .normalization import LayerNorm

__all__ = [
    "Dropout",
    "Embedding",
    "GELU",
    "LayerNorm",
    "Linear",
    "Module",
    "MultiheadAttention",
    "Sequential",
]
