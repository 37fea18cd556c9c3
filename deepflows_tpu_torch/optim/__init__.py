"""optim (counterpart of ``deepflows_tpu/optim``): the ``Optimizer`` base,
its nine optimizers, the learning-rate schedulers, gradient clipping by
global norm and ``ModelEMA``."""

from .adadelta import Adadelta
from .adafactor import Adafactor
from .adagrad import Adagrad
from .adam import Adam
from .adamw import AdamW
from .clip import clip_by_global_norm, clip_grad_norm_
from .ema import ModelEMA
from .lion import Lion
from .muon import Muon
from .optimizer import Optimizer
from .rmsprop import RMSprop
from .scheduler import (
    CosineAnnealingLR,
    LinearLR,
    LRScheduler,
    OneCycleLR,
    StepLR,
    WarmupCosineLR,
)
from .sgd import SGD

__all__ = [
    "Optimizer",
    "SGD",
    "Adam",
    "AdamW",
    "RMSprop",
    "Adagrad",
    "Adadelta",
    "Adafactor",
    "Lion",
    "Muon",
    "LRScheduler",
    "StepLR",
    "CosineAnnealingLR",
    "WarmupCosineLR",
    "LinearLR",
    "OneCycleLR",
    "clip_grad_norm_",
    "clip_by_global_norm",
    "ModelEMA",
]
