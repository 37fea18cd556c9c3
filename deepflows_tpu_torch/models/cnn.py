"""Workload models of the reference's test scripts (counterpart of
``deepflows_tpu/models/cnn.py``): the MLP and the MNIST, CIFAR-10 and
Dishes CNNs, with the JAX package's module names."""

from __future__ import annotations

import torch

from .. import nn
from ..device import Device
from ..nn import functional as F


class MLP(nn.Module):
    """784→100→20→10 ReLU MLP (reference ``test/MLP_MNIST.py:72-80``).  Its
    layers are ``layers.0`` … ``layers.2``, the JAX package's keys."""

    def __init__(self, in_features=784, hidden=(100, 20), num_classes=10, device=None):
        super().__init__()
        dims = [in_features, *hidden, num_classes]
        self.layers = torch.nn.ModuleList(
            [nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:])]
        )

    def forward(self, x):
        if x.dim() > 2:
            x = x.flatten(1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MNIST_CNN(nn.Module):
    """conv5(1→32)-pool-conv5(32→64)-pool-fc
    (reference ``test/CNN_MNIST_cuda.py:75-81``)."""

    def __init__(self, num_classes=10, device=None):
        super().__init__()
        dev = Device(device)
        self.conv1 = nn.Conv2d(1, 32, kernel_size=5, padding=2, device=dev)
        self.relu1 = nn.ReLU()
        self.pool1 = nn.MaxPool2d(kernel_size=2, stride=2)
        self.conv2 = nn.Conv2d(32, 64, kernel_size=5, padding=2, device=dev)
        self.relu2 = nn.ReLU()
        self.pool2 = nn.MaxPool2d(kernel_size=2, stride=2)
        self.fc = nn.Linear(64 * 7 * 7, num_classes, device=dev)

    def forward(self, x):
        x = self.pool1(self.relu1(self.conv1(x)))
        x = self.pool2(self.relu2(self.conv2(x)))
        return self.fc(x.reshape(x.shape[0], -1))


class CIFAR10_CNN(nn.Module):
    """Three conv-BN-ReLU-pool blocks (conv5, conv5, conv3), dropout and an
    fc for 3×32×32 inputs (reference ``test/CNN_CIFAR10_cuda.py:61-108``)."""

    def __init__(self, num_classes=10, device=None):
        super().__init__()
        dev = Device(device)
        for i, (cin, cout, k) in enumerate(((3, 32, 5), (32, 64, 5), (64, 128, 3)), 1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, kernel_size=k, padding=k // 2,
                                               device=dev))
            setattr(self, f"bn{i}", nn.BatchNorm2d(cout, device=dev))
            setattr(self, f"relu{i}", nn.ReLU())
            setattr(self, f"pool{i}", nn.MaxPool2d(kernel_size=2, stride=2))
        self.drop = nn.Dropout(0.5)
        self.fc = nn.Linear(128 * 4 * 4, num_classes, device=dev)

    def forward(self, x):
        for i in (1, 2, 3):
            block = [getattr(self, f"{n}{i}") for n in ("conv", "bn", "relu", "pool")]
            for layer in block:
                x = layer(x)
        x = self.drop(x.reshape(x.shape[0], -1))
        return self.fc(x)


class DishesCNN(nn.Module):
    """CNN(3→64→128→256) with dropout for the Dishes workload (reference
    ``test/CNN_Dishes_cuda.py``)."""

    def __init__(self, num_classes=10, img_size=64, device=None):
        super().__init__()
        dev = Device(device)
        layers = []
        for cin, cout in ((3, 64), (64, 128), (128, 256)):
            layers += [nn.Conv2d(cin, cout, 3, padding=1, device=dev),
                       nn.BatchNorm2d(cout, device=dev), nn.ReLU(), nn.MaxPool2d(2, 2)]
        self.features = nn.Sequential(*layers)
        feat = img_size // 8
        self.classifier = nn.Sequential(
            nn.Dropout(0.5),
            nn.Linear(256 * feat * feat, 512, device=dev),
            nn.ReLU(),
            nn.Dropout(0.5),
            nn.Linear(512, num_classes, device=dev),
        )

    def forward(self, x):
        x = self.features(x)
        return self.classifier(x.reshape(x.shape[0], -1))
