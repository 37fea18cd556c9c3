from deepflows_tpu_torch.nn import *  # noqa: F401,F403
from deepflows_tpu_torch.nn import functional, init, Parameter  # noqa: F401
