"""MobileNetV1 with true depthwise-separable convolutions (``groups ==
channels``) and MobileNetV2 (counterpart of
``deepflows_tpu/models/mobilenet.py``), torchvision's layout."""

from __future__ import annotations

from .. import nn
from ..device import Device

# (out_channels, stride) of each depthwise-separable block after the stem
MOBILENET_V1_BLOCKS = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)


def make_divisible(v, divisor=8, min_value=None):
    """Width-multiplier channel rounding (reference ``test/MobileNet.py:38-46``)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Module):
    def __init__(self, inp, oup, kernel_size=3, stride=1, groups=1, device=None, act="relu"):
        super().__init__()
        self.conv = nn.Conv2d(inp, oup, kernel_size, stride, (kernel_size - 1) // 2,
                              groups=groups, bias=False, device=device)
        self.bn = nn.BatchNorm2d(oup, device=device)
        self.relu = nn.ReLU6() if act == "relu6" else nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Module):
    def __init__(self, inp, oup, stride, device=None):
        super().__init__()
        self.depthwise = ConvBNReLU(inp, inp, 3, stride, groups=inp, device=device)
        self.pointwise = ConvBNReLU(inp, oup, 1, 1, device=device)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes=1000, width_multiplier=1.0, in_channels=3, device=None):
        super().__init__()
        dev = Device(device)
        c_in = make_divisible(32 * width_multiplier)
        layers = [ConvBNReLU(in_channels, c_in, 3, 2, device=dev)]
        for c_out, stride in MOBILENET_V1_BLOCKS:
            c = make_divisible(c_out * width_multiplier)
            layers.append(DepthwiseSeparable(c_in, c, stride, device=dev))
            c_in = c
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(c_in, num_classes, device=dev)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.fc(x.reshape(x.shape[0], -1))


class InvertedResidual(nn.Module):
    """Expand 1x1 → depthwise 3x3 → linear 1x1 projection, with a residual
    when the stride is 1 and the widths match."""

    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, 1, device=device, act="relu6"))
        layers += [
            ConvBNReLU(hidden, hidden, 3, stride, groups=hidden, device=device, act="relu6"),
            nn.Conv2d(hidden, oup, 1, 1, 0, bias=False, device=device),
            nn.BatchNorm2d(oup, device=device),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    _SETTINGS = (  # t, c, n, s (torchvision's)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, num_classes=1000, width_multiplier=1.0, in_channels=3,
                 small_input=False, device=None):
        super().__init__()
        dev = Device(device)
        wm = width_multiplier
        c = make_divisible(32 * wm)
        features = [ConvBNReLU(in_channels, c, 3, 1 if small_input else 2, device=dev,
                               act="relu6")]
        for t, ch, n, s in self._SETTINGS:
            out_c = make_divisible(ch * wm)
            for i in range(n):
                features.append(InvertedResidual(c, out_c, s if i == 0 else 1, t, device=dev))
                c = out_c
        last = make_divisible(1280 * max(1.0, wm))
        features.append(ConvBNReLU(c, last, 1, device=dev, act="relu6"))
        self.features = nn.Sequential(*features)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.classifier = nn.Sequential(nn.Dropout(0.2), nn.Linear(last, num_classes, device=dev))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))
