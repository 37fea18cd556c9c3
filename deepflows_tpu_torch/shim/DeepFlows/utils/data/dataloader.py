from deepflows_tpu_torch.utils.data.dataloader import *  # noqa: F401,F403
from deepflows_tpu_torch.utils.data.dataloader import DataLoader, data_loader  # noqa: F401
