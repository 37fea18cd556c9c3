from deepflows_tpu_torch.utils.data.dataset import Dataset, TensorDataset  # noqa: F401
