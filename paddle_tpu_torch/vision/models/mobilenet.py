"""MobileNet V1/V2/V3 (counterpart of ``paddle_tpu/vision/models/mobilenet.py``).

Depthwise convs are grouped convolutions (cuDNN's on the card).
"""

from __future__ import annotations

import torch

from ... import nn
from ...device import resolve_device


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvNormActivation(nn.Sequential):
    """conv + bn + activation building block (reference: vision/ops.py)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, norm_layer=nn.BatchNorm2D,
                 activation_layer=nn.ReLU, dilation=1, bias=None):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        if bias is None:
            bias = norm_layer is None
        layers = [nn.Conv2D(in_channels, out_channels, kernel_size, stride, padding,
                            dilation=dilation, groups=groups,
                            bias_attr=None if bias else False)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels))
        if activation_layer is not None:
            layers.append(activation_layer())
        super().__init__(*layers)


# ----------------------------------------------------------------- V1
class _DepthwiseSeparable(torch.nn.Module):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups, stride,
                 scale):
        super().__init__()
        self._dw = ConvNormActivation(in_channels, int(out_channels1 * scale), 3,
                                      stride=stride, groups=int(num_groups * scale))
        self._pw = ConvNormActivation(int(out_channels1 * scale),
                                      int(out_channels2 * scale), 1, stride=1, padding=0)

    def forward(self, x):
        return self._pw(self._dw(x))


class MobileNetV1(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvNormActivation(3, int(32 * scale), 3, stride=2)
        cfg = [
            # in, out1, out2, groups, stride
            (int(32 * scale), 32, 64, 32, 1),
            (int(64 * scale), 64, 128, 64, 2),
            (int(128 * scale), 128, 128, 128, 1),
            (int(128 * scale), 128, 256, 128, 2),
            (int(256 * scale), 256, 256, 256, 1),
            (int(256 * scale), 256, 512, 256, 2),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 1024, 512, 2),
            (int(1024 * scale), 1024, 1024, 1024, 1),
        ]
        blocks = [_DepthwiseSeparable(i, o1, o2, g, s, scale) for i, o1, o2, g, s in cfg]
        self.blocks = nn.Sequential(*blocks)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


# ----------------------------------------------------------------- V2
class InvertedResidual(torch.nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, norm_layer=nn.BatchNorm2D):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup

        layers = []
        if expand_ratio != 1:
            layers.append(ConvNormActivation(inp, hidden_dim, kernel_size=1, padding=0,
                                             norm_layer=norm_layer,
                                             activation_layer=nn.ReLU6))
        layers.extend([
            ConvNormActivation(hidden_dim, hidden_dim, stride=stride, groups=hidden_dim,
                               norm_layer=norm_layer, activation_layer=nn.ReLU6),
            nn.Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False),
            norm_layer(oup),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280

        inverted_residual_setting = [
            [1, 16, 1, 1],
            [6, 24, 2, 2],
            [6, 32, 3, 2],
            [6, 64, 4, 2],
            [6, 96, 3, 1],
            [6, 160, 3, 2],
            [6, 320, 1, 1],
        ]

        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvNormActivation(3, input_channel, stride=2,
                                       activation_layer=nn.ReLU6)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                stride = s if i == 0 else 1
                features.append(InvertedResidual(input_channel, output_channel, stride,
                                                 expand_ratio=t))
                input_channel = output_channel
        features.append(ConvNormActivation(input_channel, self.last_channel,
                                           kernel_size=1, padding=0,
                                           activation_layer=nn.ReLU6))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


# ----------------------------------------------------------------- V3
class SqueezeExcitation(torch.nn.Module):
    def __init__(self, input_channels, squeeze_channels):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(input_channels, squeeze_channels, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_channels, input_channels, 1)
        self.hardsigmoid = nn.Hardsigmoid()

    def forward(self, x):
        scale = self.avgpool(x)
        scale = self.relu(self.fc1(scale))
        scale = self.hardsigmoid(self.fc2(scale))
        return x * scale


class _V3Block(torch.nn.Module):
    def __init__(self, in_c, exp_c, out_c, kernel, use_se, act, stride):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        act_layer = nn.Hardswish if act == "HS" else nn.ReLU
        layers = []
        if exp_c != in_c:
            layers.append(ConvNormActivation(in_c, exp_c, 1, padding=0,
                                             activation_layer=act_layer))
        layers.append(ConvNormActivation(exp_c, exp_c, kernel, stride=stride,
                                         groups=exp_c, activation_layer=act_layer))
        if use_se:
            layers.append(SqueezeExcitation(exp_c, _make_divisible(exp_c // 4)))
        layers.append(ConvNormActivation(exp_c, out_c, 1, padding=0,
                                         activation_layer=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_LARGE = [
    # k, exp, out, se, act, s
    (3, 16, 16, False, "RE", 1),
    (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1),
    (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1),
    (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2),
    (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1),
    (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2),
    (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]

_V3_SMALL = [
    (3, 16, 16, True, "RE", 2),
    (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1),
    (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1),
    (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1),
    (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2),
    (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]


class _MobileNetV3(torch.nn.Module):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        in_c = _make_divisible(16 * scale)
        layers = [ConvNormActivation(3, in_c, 3, stride=2, activation_layer=nn.Hardswish)]
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            layers.append(_V3Block(in_c, exp_c, out_c, k, se, act, s))
            in_c = out_c
        last_conv = _make_divisible(6 * in_c)
        layers.append(ConvNormActivation(in_c, last_conv, 1, padding=0,
                                         activation_layer=nn.Hardswish))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel),
                nn.Hardswish(),
                nn.Dropout(0.2),
                nn.Linear(last_channel, num_classes),
            )

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__(_V3_LARGE, _make_divisible(1280 * scale), scale, num_classes,
                         with_pool, device, dtype)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__(_V3_SMALL, _make_divisible(1024 * scale), scale, num_classes,
                         with_pool, device, dtype)


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (no network egress)")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
