"""Dataset protocol (counterpart of ``deepflows_tpu/utils/data/dataset.py``)."""


class Dataset:
    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Array-backed dataset with fancy-index batching: ``dataset[index_list]``
    takes a whole batch of numpy rows in one indexing."""

    def __init__(self, *arrays):
        if not arrays or any(len(a) != len(arrays[0]) for a in arrays):
            raise ValueError("TensorDataset needs arrays of one length")
        self.arrays = arrays

    def __getitem__(self, index):
        out = tuple(a[index] for a in self.arrays)
        return out if len(out) > 1 else out[0]

    def __len__(self):
        return len(self.arrays[0])
