from deepflows_tpu_torch.utils import *  # noqa: F401,F403
from deepflows_tpu_torch.utils import (  # noqa: F401
    Accumulator,
    Animator,
    accuracy,
    evaluate_accuracy,
    load_checkpoint,
    save_checkpoint,
)
from deepflows_tpu_torch.utils.data import DataLoader, Dataset, data_loader  # noqa: F401
