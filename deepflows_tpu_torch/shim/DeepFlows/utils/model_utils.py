from deepflows_tpu_torch.utils.model_utils import load_checkpoint, save_checkpoint  # noqa: F401
