from .activation import (
    GELU,
    LeakyReLU,
    LogSoftmax,
    ReLU,
    ReLU6,
    Sigmoid,
    SiLU,
    Softmax,
    Tanh,
)
from .batchnorm import BatchNorm1d, BatchNorm2d
from .attention import MultiheadAttention
from .container import Sequential
from .conv import Conv1d, Conv2d, WSConv2d
from .dropout import Dropout
from .embedding import Embedding
from .flatten import Flatten
from .linear import Identity, Linear
from .loss import CrossEntropyLoss, LMHeadCrossEntropy
from .module import Module
from .moe import MoE, MoECriterion
from .normalization import GroupNorm, LayerNorm, RMSNorm
from .pool import AdaptiveAvgPool2d, AvgPool1d, AvgPool2d, MaxPool1d, MaxPool2d
from .remat import Remat, remat_call

__all__ = [
    "AdaptiveAvgPool2d",
    "AvgPool1d",
    "AvgPool2d",
    "BatchNorm1d",
    "BatchNorm2d",
    "Conv1d",
    "Conv2d",
    "CrossEntropyLoss",
    "Dropout",
    "Embedding",
    "Flatten",
    "GELU",
    "GroupNorm",
    "Identity",
    "LayerNorm",
    "LeakyReLU",
    "Linear",
    "LMHeadCrossEntropy",
    "LogSoftmax",
    "MaxPool1d",
    "MaxPool2d",
    "Module",
    "MoE",
    "MoECriterion",
    "MultiheadAttention",
    "ReLU",
    "ReLU6",
    "Remat",
    "remat_call",
    "RMSNorm",
    "Sequential",
    "Sigmoid",
    "SiLU",
    "Softmax",
    "Tanh",
    "WSConv2d",
]
