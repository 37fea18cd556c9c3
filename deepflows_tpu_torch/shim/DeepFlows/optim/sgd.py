from deepflows_tpu_torch.optim.sgd import *  # noqa: F401,F403
from deepflows_tpu_torch.optim.sgd import SGD  # noqa: F401
