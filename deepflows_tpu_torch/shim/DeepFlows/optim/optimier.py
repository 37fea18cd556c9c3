from deepflows_tpu_torch.optim.optimizer import *  # noqa: F401,F403
from deepflows_tpu_torch.optim.optimizer import Optimizer  # noqa: F401
