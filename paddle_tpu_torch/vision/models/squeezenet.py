"""SqueezeNet (counterpart of ``paddle_tpu/vision/models/squeezenet.py``)."""

import torch

from ... import nn
from ...device import resolve_device


class _Fire(torch.nn.Module):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes, expand3x3_planes):
        super().__init__()
        self.squeeze = nn.Conv2D(inplanes, squeeze_planes, 1)
        self.squeeze_activation = nn.ReLU()
        self.expand1x1 = nn.Conv2D(squeeze_planes, expand1x1_planes, 1)
        self.expand1x1_activation = nn.ReLU()
        self.expand3x3 = nn.Conv2D(squeeze_planes, expand3x3_planes, 3, padding=1)
        self.expand3x3_activation = nn.ReLU()

    def forward(self, x):
        x = self.squeeze_activation(self.squeeze(x))
        return torch.cat([
            self.expand1x1_activation(self.expand1x1(x)),
            self.expand3x3_activation(self.expand3x3(x)),
        ], dim=1)


class SqueezeNet(torch.nn.Module):
    def __init__(self, version="1.1", num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(96, 16, 64, 64),
                _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 32, 128, 128),
                _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(512, 64, 256, 256),
            )
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(64, 16, 64, 64),
                _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(128, 32, 128, 128),
                _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256),
                _Fire(512, 64, 256, 256),
            )
        else:
            raise ValueError(f"unsupported SqueezeNet version {version!r}")
        if num_classes > 0:
            final_conv = nn.Conv2D(512, num_classes, 1)
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), final_conv, nn.ReLU())
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (no network egress)")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (no network egress)")
    return SqueezeNet("1.1", **kwargs)
