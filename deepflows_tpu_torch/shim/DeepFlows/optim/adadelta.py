from deepflows_tpu_torch.optim.adadelta import *  # noqa: F401,F403
from deepflows_tpu_torch.optim.adadelta import Adadelta  # noqa: F401
