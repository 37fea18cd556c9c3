from deepflows_tpu_torch.backend_selection import *  # noqa: F401,F403
