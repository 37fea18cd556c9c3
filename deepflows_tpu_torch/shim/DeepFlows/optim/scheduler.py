from deepflows_tpu_torch.optim.scheduler import *  # noqa: F401,F403
from deepflows_tpu_torch.optim.scheduler import (  # noqa: F401
    CosineAnnealingLR,
    LRScheduler,
    StepLR,
    WarmupCosineLR,
)
