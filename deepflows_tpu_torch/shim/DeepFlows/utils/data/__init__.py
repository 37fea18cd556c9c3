from deepflows_tpu_torch.utils.data import *  # noqa: F401,F403
