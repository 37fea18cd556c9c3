"""optim (counterpart of ``deepflows_tpu/optim``): the ``Optimizer`` base,
``Adam`` and ``SGD``; the other optimizers, clipping and schedulers come
with later slices."""

from .adam import Adam
from .optimizer import Optimizer
from .sgd import SGD

__all__ = ["Adam", "Optimizer", "SGD"]
