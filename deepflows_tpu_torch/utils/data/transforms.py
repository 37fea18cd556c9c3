"""Batch augmentations (counterpart of ``deepflows_tpu/utils/data/transforms.py``):
composable transforms over NCHW numpy batches on the host, run in a
loader's ``collate_fn`` (on its prefetch thread).  Each draws from its own
numpy ``default_rng(seed)`` in the JAX package's order, so one seed gives
the same bits in both packages."""

from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            x = t(x)
        return x


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, seed=None):
        self.p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        flip = self._rng.random(len(x)) < self.p
        x = x.copy()
        x[flip] = x[flip][..., ::-1]
        return x


class RandomCrop:
    """Pad with zeros, then crop ``size`` x ``size`` at a random offset per
    image (CIFAR's 32 → pad 4 → crop 32)."""

    def __init__(self, size: int, padding: int = 4, seed=None):
        self.size = size
        self.padding = padding
        self._rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        n, c, h, w = x.shape
        p = self.padding
        xp = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)))
        out = np.empty((n, c, self.size, self.size), dtype=x.dtype)
        ys = self._rng.integers(0, h + 2 * p - self.size + 1, n)
        xs = self._rng.integers(0, w + 2 * p - self.size + 1, n)
        for i in range(n):
            out[i] = xp[i, :, ys[i] : ys[i] + self.size, xs[i] : xs[i] + self.size]
        return out


class RandomErasing:
    """Zero a random square of each image with probability ``p``."""

    def __init__(self, p: float = 0.5, scale=(0.02, 0.2), seed=None):
        self.p = p
        self.scale = scale
        self._rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        n, c, h, w = x.shape
        x = x.copy()
        for i in range(n):
            if self._rng.random() >= self.p:
                continue
            area = self._rng.uniform(*self.scale) * h * w
            side = max(1, int(np.sqrt(area)))
            eh, ew = min(side, h), min(side, w)
            y0 = self._rng.integers(0, h - eh + 1)
            x0 = self._rng.integers(0, w - ew + 1)
            x[i, :, y0 : y0 + eh, x0 : x0 + ew] = 0.0
        return x


class Normalize:
    """Per-channel ``(x - mean) / std`` over NCHW."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32).reshape(1, -1, 1, 1)
        self.std = np.asarray(std, dtype=np.float32).reshape(1, -1, 1, 1)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std
