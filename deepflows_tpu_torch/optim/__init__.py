"""optim (counterpart of ``deepflows_tpu/optim``): the ``Optimizer`` base
and ``Adam``; the other optimizers, clipping and schedulers come with later
slices."""

from .adam import Adam
from .optimizer import Optimizer

__all__ = ["Adam", "Optimizer"]
