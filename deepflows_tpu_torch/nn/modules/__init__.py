from .activation import GELU, ReLU, Tanh
from .attention import MultiheadAttention
from .container import Sequential
from .dropout import Dropout
from .embedding import Embedding
from .linear import Linear
from .loss import CrossEntropyLoss, LMHeadCrossEntropy
from .module import Module
from .normalization import LayerNorm

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
]
