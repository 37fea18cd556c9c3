"""The ResNet family (counterpart of ``deepflows_tpu/models/resnet.py``):
BasicBlock and Bottleneck with BatchNorm, the norm-free NF blocks (scaled
weight-standardised convs, scaled ReLUs, variance-tracked residuals), and
ResNet18/34/50.  Module names are torchvision's (conv1, bn1, layer1 ..
layer4, fc; downsample.0 / downsample.1), the JAX package's too, so a
torchvision state dict maps by name.  ``remat=True`` recomputes each
residual block in backward (``nn.remat_call``)."""

from __future__ import annotations

from .. import nn
from ..device import Device


def conv3x3(in_planes, out_planes, stride=1, device=None):
    return nn.Conv2d(in_planes, out_planes, 3, stride=stride, padding=1, bias=False,
                     device=device)


def conv1x1(in_planes, out_planes, stride=1, device=None):
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, padding=0, bias=False,
                     device=device)


class _Block(nn.Module):
    """A residual block whose forward may be rematerialised."""

    def forward(self, x):
        if self._remat:
            return nn.remat_call(self, x, self._forward_impl)
        return self._forward_impl(x)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, device=None, remat=False):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.relu = nn.ReLU()
        self.conv2 = conv3x3(planes, planes, device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.downsample = downsample
        self.stride = stride
        self._remat = remat

    def _forward_impl(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, device=None, remat=False):
        super().__init__()
        self.conv1 = conv1x1(inplanes, planes, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = conv3x3(planes, planes, stride, device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.conv3 = conv1x1(planes, planes * self.expansion, device=device)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion, device=device)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride
        self._remat = remat

    def _forward_impl(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


ResidualBlock = BasicBlock  # the reference script's name (test/ResNet.py:24)


# ------------------------------------------------------------------ norm-free
_GAMMA = nn.WSConv2d.GAMMA_RELU


def ws3x3(in_planes, out_planes, stride=1, device=None):
    return nn.WSConv2d(in_planes, out_planes, 3, stride=stride, padding=1, bias=False,
                       device=device)


def ws1x1(in_planes, out_planes, stride=1, device=None):
    return nn.WSConv2d(in_planes, out_planes, 1, stride=stride, padding=0, bias=False,
                       device=device)


class _NFBlock(_Block):
    """``h + alpha · f(relu(h / beta) · gamma)``; a transition's shortcut is
    a conv of the same activated input."""

    def _init(self, downsample, stride, beta, alpha, remat):
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride
        self.beta = float(beta)
        self.alpha = float(alpha)
        self._remat = remat

    def _forward_impl(self, x):
        out = self.relu(x * (1.0 / self.beta)) * _GAMMA
        identity = x if self.downsample is None else self.downsample(out)
        convs = self._convs()
        for conv in convs[:-1]:
            out = self.relu(conv(out)) * _GAMMA
        return identity + convs[-1](out) * self.alpha


class NFBasicBlock(_NFBlock):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, device=None,
                 remat=False, beta=1.0, alpha=0.2):
        super().__init__()
        self.conv1 = ws3x3(inplanes, planes, stride, device=device)
        self.conv2 = ws3x3(planes, planes, device=device)
        self._init(downsample, stride, beta, alpha, remat)

    def _convs(self):
        return (self.conv1, self.conv2)


class NFBottleneck(_NFBlock):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, device=None,
                 remat=False, beta=1.0, alpha=0.2):
        super().__init__()
        self.conv1 = ws1x1(inplanes, planes, device=device)
        self.conv2 = ws3x3(planes, planes, stride, device=device)
        self.conv3 = ws1x1(planes, planes * self.expansion, device=device)
        self._init(downsample, stride, beta, alpha, remat)

    def _convs(self):
        return (self.conv1, self.conv2, self.conv3)


class ResNet(nn.Module):
    def __init__(self, block, layers, num_classes=1000, in_channels=3, small_input=False,
                 device=None, remat=False, norm="batch", alpha=0.2):
        """``small_input=True``: a 3×3 stride-1 stem and no max pool (the
        CIFAR adaptation).  ``remat=True`` rematerialises each residual
        block.  ``norm="free"``: the NF-ResNet (WSConv2d, scaled
        activations, residual scale ``alpha``), whose state dict is not
        the ``norm="batch"`` one."""
        super().__init__()
        if norm not in ("batch", "free"):
            raise ValueError(f"norm must be 'batch' or 'free', got {norm!r}")
        dev = Device(device)
        self.inplanes = 64
        self._device = dev
        self._block_remat = remat
        self._norm = norm
        self._alpha = float(alpha)
        self._expected_var = 1.0
        if norm == "free":
            block = {BasicBlock: NFBasicBlock, Bottleneck: NFBottleneck}.get(block, block)
        stem = nn.WSConv2d if norm == "free" else nn.Conv2d
        if small_input:
            self.conv1 = stem(in_channels, 64, 3, stride=1, padding=1, bias=False, device=dev)
            self.maxpool = None
        else:
            self.conv1 = stem(in_channels, 64, 7, stride=2, padding=3, bias=False, device=dev)
            self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        if norm == "batch":
            self.bn1 = nn.BatchNorm2d(64, device=dev)
        self.relu = nn.ReLU()
        make = self._make_layer_free if norm == "free" else self._make_layer_batch
        self.layer1 = make(block, 64, layers[0])
        self.layer2 = make(block, 128, layers[1], stride=2)
        self.layer3 = make(block, 256, layers[2], stride=2)
        self.layer4 = make(block, 512, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512 * block.expansion, num_classes, device=dev)

    def _make_layer_free(self, block, planes, blocks, stride=1):
        layers = []
        for i in range(blocks):
            s = stride if i == 0 else 1
            transition = s != 1 or self.inplanes != planes * block.expansion
            downsample = (ws1x1(self.inplanes, planes * block.expansion, s, device=self._device)
                          if transition else None)
            layers.append(block(self.inplanes, planes, s, downsample, device=self._device,
                                remat=self._block_remat, beta=self._expected_var ** 0.5,
                                alpha=self._alpha))
            self.inplanes = planes * block.expansion
            # the branch adds alpha² of variance; a transition resets the base
            self._expected_var = (1.0 if transition else self._expected_var) + self._alpha**2
        return nn.Sequential(*layers)

    def _make_layer_batch(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                conv1x1(self.inplanes, planes * block.expansion, stride, device=self._device),
                nn.BatchNorm2d(planes * block.expansion, device=self._device),
            )
        layers = [block(self.inplanes, planes, stride, downsample, device=self._device,
                        remat=self._block_remat)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, device=self._device,
                                remat=self._block_remat))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.conv1(x)
        if self._norm == "batch":
            x = self.relu(self.bn1(x))
        if self.maxpool is not None:
            x = self.maxpool(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self._norm == "free":  # NF blocks activate their own inputs
            x = self.relu(x)
        x = self.avgpool(x)
        return self.fc(x.reshape(x.shape[0], -1))


def ResNet18(num_classes=1000, in_channels=3, small_input=False, device=None, remat=False,
             norm="batch"):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, in_channels, small_input, device,
                  remat, norm)


def ResNet34(num_classes=1000, in_channels=3, small_input=False, device=None, remat=False,
             norm="batch"):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, in_channels, small_input, device,
                  remat, norm)


def ResNet50(num_classes=1000, in_channels=3, small_input=False, device=None, remat=False,
             norm="batch"):
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, in_channels, small_input, device,
                  remat, norm)
