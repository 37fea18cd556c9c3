from deepflows_tpu_torch.backend import *  # noqa: F401,F403
