"""GoogLeNet (Inception v1) and InceptionV3 (counterpart of
``paddle_tpu/vision/models/inception.py``, built from the papers' block
structure).  They lean on ``ceil_mode`` / exclusive average pooling and
uneven adaptive bins; ``GoogLeNet`` returns ``(out, aux1, aux2)`` in
training."""

from __future__ import annotations

import torch

from ... import nn
from ...device import resolve_device


def _cbr(cin, cout, k, s=1, p=0):
    return nn.Sequential(
        nn.Conv2D(cin, cout, k, stride=s, padding=p, bias_attr=False),
        nn.BatchNorm2D(cout), nn.ReLU())


class _InceptionV1Block(torch.nn.Module):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, pool_proj):
        super().__init__()
        self.b1 = _cbr(cin, c1, 1)
        self.b3 = nn.Sequential(_cbr(cin, c3r, 1), _cbr(c3r, c3, 3, p=1))
        self.b5 = nn.Sequential(_cbr(cin, c5r, 1), _cbr(c5r, c5, 5, p=2))
        self.bp = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _cbr(cin, pool_proj, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)], dim=1)


class GoogLeNet(torch.nn.Module):
    """Inception v1, 22 layers; aux classifiers return alongside the main
    logits in train mode (reference returns (out, aux1, aux2))."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=None):
        super().__init__()
        self.stem = nn.Sequential(
            _cbr(3, 64, 7, s=2, p=3), nn.MaxPool2D(3, 2, padding=1),
            _cbr(64, 64, 1), _cbr(64, 192, 3, p=1), nn.MaxPool2D(3, 2, padding=1))
        self.i3a = _InceptionV1Block(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _InceptionV1Block(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.i4a = _InceptionV1Block(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _InceptionV1Block(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _InceptionV1Block(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _InceptionV1Block(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _InceptionV1Block(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.i5a = _InceptionV1Block(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _InceptionV1Block(832, 384, 192, 384, 48, 128, 128)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        a1 = self.aux1(x) if self.training and self.num_classes > 0 else None
        x = self.i4c(self.i4b(x))
        x = self.i4d(x)
        a2 = self.aux2(x) if self.training and self.num_classes > 0 else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        if self.training and self.num_classes > 0:
            return x, a1, a2
        return x


class _AuxHead(torch.nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = _cbr(cin, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.act = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x)).flatten(1)
        return self.fc2(self.dropout(self.act(self.fc1(x))))


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a "
                         "state_dict with set_state_dict instead")
    return GoogLeNet(**kwargs)


# ------------------------------------------------------------ Inception v3
class _InceptionA(torch.nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.b1 = _cbr(cin, 64, 1)
        self.b5 = nn.Sequential(_cbr(cin, 48, 1), _cbr(48, 64, 5, p=2))
        self.b3 = nn.Sequential(_cbr(cin, 64, 1), _cbr(64, 96, 3, p=1),
                                _cbr(96, 96, 3, p=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _cbr(cin, pool_features, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], dim=1)


class _InceptionB(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.b3 = _cbr(cin, 384, 3, s=2)
        self.b3d = nn.Sequential(_cbr(cin, 64, 1), _cbr(64, 96, 3, p=1),
                                 _cbr(96, 96, 3, s=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class _InceptionC(torch.nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.b1 = _cbr(cin, 192, 1)
        self.b7 = nn.Sequential(
            _cbr(cin, c7, 1), _cbr(c7, c7, (1, 7), p=(0, 3)),
            _cbr(c7, 192, (7, 1), p=(3, 0)))
        self.b7d = nn.Sequential(
            _cbr(cin, c7, 1), _cbr(c7, c7, (7, 1), p=(3, 0)),
            _cbr(c7, c7, (1, 7), p=(0, 3)), _cbr(c7, c7, (7, 1), p=(3, 0)),
            _cbr(c7, 192, (1, 7), p=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _cbr(cin, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], dim=1)


class _InceptionD(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.b3 = nn.Sequential(_cbr(cin, 192, 1), _cbr(192, 320, 3, s=2))
        self.b7 = nn.Sequential(
            _cbr(cin, 192, 1), _cbr(192, 192, (1, 7), p=(0, 3)),
            _cbr(192, 192, (7, 1), p=(3, 0)), _cbr(192, 192, 3, s=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class _InceptionE(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.b1 = _cbr(cin, 320, 1)
        self.b3_stem = _cbr(cin, 384, 1)
        self.b3_a = _cbr(384, 384, (1, 3), p=(0, 1))
        self.b3_b = _cbr(384, 384, (3, 1), p=(1, 0))
        self.bd_stem = nn.Sequential(_cbr(cin, 448, 1), _cbr(448, 384, 3, p=1))
        self.bd_a = _cbr(384, 384, (1, 3), p=(0, 1))
        self.bd_b = _cbr(384, 384, (3, 1), p=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _cbr(cin, 192, 1))

    def forward(self, x):
        s3 = self.b3_stem(x)
        sd = self.bd_stem(x)
        return torch.cat([self.b1(x),
                       torch.cat([self.b3_a(s3), self.b3_b(s3)], dim=1),
                       torch.cat([self.bd_a(sd), self.bd_b(sd)], dim=1),
                       self.bp(x)], dim=1)


class InceptionV3(torch.nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=None):
        super().__init__()
        self.stem = nn.Sequential(
            _cbr(3, 32, 3, s=2), _cbr(32, 32, 3), _cbr(32, 64, 3, p=1),
            nn.MaxPool2D(3, 2), _cbr(64, 80, 1), _cbr(80, 192, 3),
            nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048))
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a "
                         "state_dict with set_state_dict instead")
    return InceptionV3(**kwargs)
