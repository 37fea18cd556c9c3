from deepflows_tpu_torch.nn.init import *  # noqa: F401,F403
