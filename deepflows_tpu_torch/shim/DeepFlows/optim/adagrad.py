from deepflows_tpu_torch.optim.adagrad import *  # noqa: F401,F403
from deepflows_tpu_torch.optim.adagrad import Adagrad  # noqa: F401
