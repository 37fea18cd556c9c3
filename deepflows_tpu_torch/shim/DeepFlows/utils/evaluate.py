from deepflows_tpu_torch.utils.evaluate import *  # noqa: F401,F403
from deepflows_tpu_torch.utils.evaluate import Accumulator, accuracy, evaluate_accuracy  # noqa: F401
