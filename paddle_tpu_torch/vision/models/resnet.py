"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``).

BASELINE.json's config #1 trains ``resnet50`` on ImageNet.  The bottleneck
puts its stride on the 3x3 conv (ResNet-B), as the reference does.  The
convolutions are cuDNN's on the card and the batch norms the port's
(:func:`...nn.functional.batch_norm`, the reference's running update and
rounding); no kernel of the repo runs here.  ``ResNet`` and the 14
constructors take ``device=`` (None: the card, an error without one;
``"cpu"``) and ``dtype=``, as the text models do: the weights are drawn
on the CPU from torch's default generator and then moved.
``pretrained=True`` raises, as in the reference (no weights are bundled).
"""

from __future__ import annotations

import torch

from ... import nn
from ...device import resolve_device


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW"):
        super().__init__()
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        if dilation > 1:
            raise NotImplementedError("dilation > 1 not supported in BasicBlock")
        df = data_format
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                               bias_attr=False, data_format=df)
        self.bn1 = norm_layer(planes, data_format=df)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=df)
        self.bn2 = norm_layer(planes, data_format=df)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW"):
        super().__init__()
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        df = data_format
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, data_format=df)
        self.bn1 = norm_layer(width, data_format=df)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation, stride=stride,
                               groups=groups, dilation=dilation, bias_attr=False,
                               data_format=df)
        self.bn2 = norm_layer(width, data_format=df)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, bias_attr=False,
                               data_format=df)
        self.bn3 = norm_layer(planes * self.expansion, data_format=df)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    """ResNet model from "Deep Residual Learning for Image Recognition".

    Args mirror the reference: block class, depth or explicit layer counts,
    width, num_classes, with_pool.
    """

    _DEPTH_CFG = {
        18: (BasicBlock, [2, 2, 2, 2]),
        34: (BasicBlock, [3, 4, 6, 3]),
        50: (BottleneckBlock, [3, 4, 6, 3]),
        101: (BottleneckBlock, [3, 4, 23, 3]),
        152: (BottleneckBlock, [3, 8, 36, 3]),
    }

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True,
                 groups=1, data_format="NCHW", device=None, dtype=None):
        super().__init__()
        layer_cfg = self._DEPTH_CFG[depth][1]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.data_format = data_format
        df = data_format

        self.conv1 = nn.Conv2D(3, self.inplanes, kernel_size=7, stride=2, padding=3,
                               bias_attr=False, data_format=df)
        self.bn1 = self._norm_layer(self.inplanes, data_format=df)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1, data_format=df)
        self.layer1 = self._make_layer(block, 64, layer_cfg[0])
        self.layer2 = self._make_layer(block, 128, layer_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layer_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layer_cfg[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.to(device=resolve_device(device), dtype=dtype)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        previous_dilation = self.dilation
        if dilate:
            self.dilation *= stride
            stride = 1
        df = self.data_format
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                          bias_attr=False, data_format=df),
                norm_layer(planes * block.expansion, data_format=df),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, previous_dilation, norm_layer,
                        data_format=df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, norm_layer=norm_layer,
                                data_format=df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(arch, Block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError(
            "pretrained weights are not bundled; load a converted "
            "state dict with text.models.load_paddle_tpu_state_dict instead")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext50_32x4d", BottleneckBlock, 50, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext50_64x4d", BottleneckBlock, 50, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext101_32x4d", BottleneckBlock, 101, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext101_64x4d", BottleneckBlock, 101, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext152_32x4d", BottleneckBlock, 152, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext152_64x4d", BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained, **kwargs)
