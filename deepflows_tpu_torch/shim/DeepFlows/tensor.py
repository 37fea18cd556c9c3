"""Shim: `DeepFlows.tensor` → deepflows_tpu_torch.tensor (plus the extra names the
reference module exposed via star-import: Device, Graph, numpy as np)."""

import numpy as np  # noqa: F401  (reference tensor.py exposed np)

from deepflows_tpu_torch.tensor import *  # noqa: F401,F403
from deepflows_tpu_torch.tensor import Graph, Tensor  # noqa: F401
from deepflows_tpu_torch.backend import Device, default_device  # noqa: F401
from deepflows_tpu_torch import backend_api  # noqa: F401
# the reference's tensor.py star-exported its own imports too
import numpy  # noqa: F401
from deepflows_tpu_torch.autograd import (  # noqa: F401
    enable_grad,
    is_grad_enable,
    no_grad,
    set_grad_enabled,
)
