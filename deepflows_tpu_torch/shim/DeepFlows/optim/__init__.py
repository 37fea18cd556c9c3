from deepflows_tpu_torch.optim import *  # noqa: F401,F403
from deepflows_tpu_torch.optim import Adam, SGD, Adagrad, Adadelta  # noqa: F401
