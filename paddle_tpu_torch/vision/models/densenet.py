"""DenseNet (counterpart of ``paddle_tpu/vision/models/densenet.py``)."""

import torch

from ... import nn
from ...device import resolve_device


class _DenseLayer(torch.nn.Module):
    def __init__(self, num_input_features, growth_rate, bn_size, drop_rate):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(num_input_features)
        self.relu1 = nn.ReLU()
        self.conv1 = nn.Conv2D(num_input_features, bn_size * growth_rate, 1, stride=1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.relu2 = nn.ReLU()
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3, stride=1,
                               padding=1, bias_attr=False)
        self.drop_rate = drop_rate
        if drop_rate > 0:
            self.dropout = nn.Dropout(drop_rate)

    def forward(self, x):
        out = self.conv1(self.relu1(self.norm1(x)))
        out = self.conv2(self.relu2(self.norm2(out)))
        if self.drop_rate > 0:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class _DenseBlock(torch.nn.Module):
    def __init__(self, num_layers, num_input_features, bn_size, growth_rate, drop_rate):
        super().__init__()
        self.layers = nn.LayerList([
            _DenseLayer(num_input_features + i * growth_rate, growth_rate, bn_size,
                        drop_rate)
            for i in range(num_layers)
        ])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Transition(torch.nn.Module):
    def __init__(self, num_input_features, num_output_features):
        super().__init__()
        self.norm = nn.BatchNorm2D(num_input_features)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(num_input_features, num_output_features, 1, stride=1,
                              bias_attr=False)
        self.pool = nn.AvgPool2D(kernel_size=2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(torch.nn.Module):
    _CFG = {
        121: (6, 12, 24, 16),
        161: (6, 12, 36, 24),
        169: (6, 12, 32, 32),
        201: (6, 12, 48, 32),
        264: (6, 12, 64, 48),
    }

    def __init__(self, layers=121, growth_rate=32, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True, device=None,
                 dtype=None):
        super().__init__()
        if layers == 161:
            growth_rate, num_init_features = 48, 96
        else:
            num_init_features = 64
        block_config = self._CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                               bias_attr=False)
        self.norm0 = nn.BatchNorm2D(num_init_features)
        self.relu0 = nn.ReLU()
        self.pool0 = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)

        num_features = num_init_features
        blocks = []
        for i, num_layers in enumerate(block_config):
            blocks.append(_DenseBlock(num_layers, num_features, bn_size, growth_rate,
                                      dropout))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                blocks.append(_Transition(num_features, num_features // 2))
                num_features //= 2
        self.blocks = nn.Sequential(*blocks)
        self.norm5 = nn.BatchNorm2D(num_features)
        self.relu5 = nn.ReLU()
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(num_features, num_classes)

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.pool0(self.relu0(self.norm0(self.conv1(x))))
        x = self.blocks(x)
        x = self.relu5(self.norm5(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def _densenet(layers, pretrained, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (no network egress)")
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
