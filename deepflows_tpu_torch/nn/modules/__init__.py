from .activation import GELU, ReLU, SiLU, Tanh
from .attention import MultiheadAttention
from .container import Sequential
from .dropout import Dropout
from .embedding import Embedding
from .linear import Linear
from .loss import CrossEntropyLoss, LMHeadCrossEntropy
from .module import Module
from .moe import MoE, MoECriterion
from .normalization import LayerNorm, RMSNorm

__all__ = [
    "CrossEntropyLoss",
    "Dropout",
    "Embedding",
    "GELU",
    "LMHeadCrossEntropy",
    "LayerNorm",
    "Linear",
    "MoE",
    "MoECriterion",
    "Module",
    "MultiheadAttention",
    "RMSNorm",
    "ReLU",
    "SiLU",
    "Sequential",
    "Tanh",
]
