"""The data pipeline (counterpart of ``deepflows_tpu/utils/data``)."""

from .dataloader import (
    BatchSampler,
    DataLoader,
    DistributedSampler,
    RandomSampler,
    Sampler,
    SequentialSampler,
    data_loader,
)
from .dataset import Dataset, TensorDataset
from .device_loader import DeviceDataLoader
from .pre import load_image_folder, read_png_images_from_folder
from .transforms import Compose, Normalize, RandomCrop, RandomErasing, RandomHorizontalFlip

__all__ = [
    "Dataset",
    "TensorDataset",
    "DataLoader",
    "data_loader",
    "Sampler",
    "SequentialSampler",
    "RandomSampler",
    "BatchSampler",
    "DistributedSampler",
    "read_png_images_from_folder",
    "load_image_folder",
    "Compose",
    "Normalize",
    "RandomCrop",
    "RandomErasing",
    "RandomHorizontalFlip",
    "DeviceDataLoader",
]
