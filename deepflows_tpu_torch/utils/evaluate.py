"""Metrics (counterpart of ``deepflows_tpu/utils/evaluate.py``): numpy
softmax, correct-prediction counts and a model's accuracy over batches."""

from __future__ import annotations

import numpy as np
import torch

from ..autograd import flag_kept


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def softmax(x, axis=-1):
    x = np.asarray(x)
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def accuracy(y_hat, y):
    """Count of correct predictions; either argument may be logits /
    one-hot rows (argmax taken) or class indices."""
    y_hat, y = _numpy(y_hat), _numpy(y)
    if y_hat.ndim > 1 and y_hat.shape[-1] > 1:
        y_hat = y_hat.argmax(axis=-1)
    if y.ndim > 1 and y.shape[-1] > 1:
        y = y.argmax(axis=-1)
    return float((y_hat.astype(np.int64) == y.astype(np.int64)).sum())


def topk_accuracy(y_hat, y, k: int = 5):
    """Count of targets among the top-k predictions of (N, C) scores; ``y``
    class indices or one-hot."""
    y_hat, y = _numpy(y_hat), _numpy(y)
    if y.ndim > 1 and y.shape[-1] > 1:
        y = y.argmax(axis=-1)
    if k >= y_hat.shape[-1]:
        return float(len(y))
    topk = np.argpartition(-y_hat, k, axis=-1)[..., :k]
    return float((topk == y.astype(np.int64)[..., None]).any(-1).sum())


@torch.no_grad()
def evaluate_accuracy(model, data_iter, device=None):
    """Mean accuracy of ``model`` in eval mode over (x, y) numpy batches,
    fed on ``device`` (the model's by default); the model's mode is
    restored afterwards."""
    was_training = model.training
    dev = device or next(model.parameters()).device
    metric = Accumulator(2)
    with flag_kept():  # eval() and train() set the tape's grad flag
        model.eval()
        try:
            for x, y in data_iter:
                out = model(torch.as_tensor(np.asarray(x), device=dev))
                metric.add(accuracy(out, y), len(np.asarray(y)))
        finally:
            model.train(was_training)
    return metric[0] / metric[1]


class Accumulator:
    def __init__(self, n):
        self.data = [0.0] * n

    def add(self, *args):
        self.data = [a + float(b) for a, b in zip(self.data, args)]

    def reset(self):
        self.data = [0.0] * len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]
