from deepflows_tpu_torch.autograd import *  # noqa: F401,F403
from deepflows_tpu_torch.autograd import (  # noqa: F401
    enable_grad,
    is_grad_enable,
    no_grad,
    set_grad_enabled,
)
