from deepflows_tpu_torch.optim.adam import *  # noqa: F401,F403
from deepflows_tpu_torch.optim.adam import Adam  # noqa: F401
