"""Image-folder loading (counterpart of ``deepflows_tpu/utils/data/pre.py``).
PIL is imported by the function that reads images, so the package imports
without it."""

from __future__ import annotations

import os

import numpy as np


def read_png_images_from_folder(folder, size=None):
    """Every image of a directory (.png, .jpg, .jpeg, .bmp, by sorted name)
    as an HWC uint8 RGB array, resized to ``size`` (width, height) if given."""
    from PIL import Image

    images = []
    for fname in sorted(os.listdir(folder)):
        if not fname.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        img = Image.open(os.path.join(folder, fname)).convert("RGB")
        if size is not None:
            img = img.resize(size)
        images.append(np.asarray(img))
    return images


def load_image_folder(root, size=(64, 64), dtype=np.float32):
    """A dataset of one subdirectory per class: (x NCHW in [0, 1], y int32,
    the sorted class names)."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    xs, ys = [], []
    for label, cls in enumerate(classes):
        for img in read_png_images_from_folder(os.path.join(root, cls), size=size):
            xs.append(img)
            ys.append(label)
    x = np.stack(xs).astype(dtype) / 255.0
    x = x.transpose(0, 3, 1, 2)  # NHWC -> NCHW
    return x, np.asarray(ys, dtype=np.int32), classes
