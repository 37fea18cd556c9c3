from deepflows_tpu_torch.nn.modules import *  # noqa: F401,F403
