"""The VGG family (counterpart of ``deepflows_tpu/models/vgg.py``):
torchvision's sequential indices (``features.N``, ``classifier.N``), with
a BatchNorm after every conv when ``batch_norm=True``."""

from __future__ import annotations

from .. import nn
from ..device import Device

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")  # torchvision's "D"


class VGG(nn.Module):
    def __init__(self, cfg, num_classes=1000, batch_norm=False, img_size=224,
                 in_channels=3, dropout=0.5, device=None):
        super().__init__()
        dev = Device(device)
        layers = []
        c_in = in_channels
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
                continue
            layers.append(nn.Conv2d(c_in, v, 3, padding=1, device=dev))
            if batch_norm:
                layers.append(nn.BatchNorm2d(v, device=dev))
            layers.append(nn.ReLU())
            c_in = v
        self.features = nn.Sequential(*layers)
        feat = min(img_size // 32, 7)
        self.avgpool = nn.AdaptiveAvgPool2d(feat)
        self.classifier = nn.Sequential(
            nn.Linear(512 * feat * feat, 4096, device=dev),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(4096, 4096, device=dev),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(4096, num_classes, device=dev),
        )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))


def VGG16(num_classes=1000, batch_norm=False, img_size=224, in_channels=3, device=None):
    return VGG(VGG16_CFG, num_classes=num_classes, batch_norm=batch_norm,
               img_size=img_size, in_channels=in_channels, device=device)
