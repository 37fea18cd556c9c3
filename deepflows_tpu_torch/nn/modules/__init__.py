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
from .container import ModuleDict, ModuleList, Sequential
from .conv import Conv1d, Conv2d, WSConv2d
from .dropout import Dropout
from .embedding import Embedding
from .flatten import Flatten
from .linear import Identity, Linear
from .loss import BCELoss, CrossEntropyLoss, L1Loss, LMHeadCrossEntropy, MSELoss, NLLLoss
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
    "BCELoss",
    "Conv1d",
    "Conv2d",
    "CrossEntropyLoss",
    "Dropout",
    "Embedding",
    "Flatten",
    "GELU",
    "GroupNorm",
    "Identity",
    "L1Loss",
    "LayerNorm",
    "LeakyReLU",
    "Linear",
    "LMHeadCrossEntropy",
    "LogSoftmax",
    "MaxPool1d",
    "MaxPool2d",
    "Module",
    "ModuleDict",
    "ModuleList",
    "MoE",
    "MoECriterion",
    "MSELoss",
    "MultiheadAttention",
    "NLLLoss",
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
