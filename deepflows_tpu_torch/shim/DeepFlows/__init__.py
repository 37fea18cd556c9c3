"""The reference's ``DeepFlows`` package over the PyTorch port.

Its modules mirror the reference's module paths file for file (with the
reference's own spelling, ``optim/optimier.py``) and re-export
``deepflows_tpu_torch``, so a script written against the reference
(``import DeepFlows``, ``from DeepFlows.tensor import *``) runs on the port
with ``device='cuda'`` naming the card.  ``python -m
deepflows_tpu_torch.shim SCRIPT [ARGS]`` puts this directory first on
``sys.path`` and runs the script.
"""

from deepflows_tpu_torch import *  # noqa: F401,F403
from deepflows_tpu_torch import (  # noqa: F401
    BackendTensor,
    Device,
    Graph,
    Tensor,
    backend_api,
    default_device,
    enable_grad,
    is_grad_enable,
    no_grad,
    set_grad_enabled,
)
from deepflows_tpu_torch import nn, optim, utils, models  # noqa: F401
