"""ShuffleNetV2 (counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``)."""

import torch

from ... import nn
from ...device import resolve_device
from ...nn.functional import channel_shuffle


def _act_layer(act):
    return nn.Swish if act == "swish" else nn.ReLU


class _InvertedResidual(torch.nn.Module):
    def __init__(self, inp, oup, stride, act="relu"):
        super().__init__()
        self.stride = stride
        act_cls = _act_layer(act)
        branch_features = oup // 2

        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride, 1, groups=inp, bias_attr=False),
                nn.BatchNorm2D(inp),
                nn.Conv2D(inp, branch_features, 1, 1, 0, bias_attr=False),
                nn.BatchNorm2D(branch_features),
                act_cls(),
            )
        else:
            self.branch1 = None

        self.branch2 = nn.Sequential(
            nn.Conv2D(inp if stride > 1 else branch_features, branch_features, 1, 1, 0,
                      bias_attr=False),
            nn.BatchNorm2D(branch_features),
            act_cls(),
            nn.Conv2D(branch_features, branch_features, 3, stride, 1,
                      groups=branch_features, bias_attr=False),
            nn.BatchNorm2D(branch_features),
            nn.Conv2D(branch_features, branch_features, 1, 1, 0, bias_attr=False),
            nn.BatchNorm2D(branch_features),
            act_cls(),
        )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(torch.nn.Module):
    _CFG = {
        0.25: [24, 24, 48, 96, 512],
        0.33: [24, 32, 64, 128, 512],
        0.5: [24, 48, 96, 192, 1024],
        1.0: [24, 116, 232, 464, 1024],
        1.5: [24, 176, 352, 704, 1024],
        2.0: [24, 244, 488, 976, 2048],
    }

    def __init__(self, scale=1.0, act="relu", num_classes=1000, with_pool=True,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        stages_repeats = [4, 8, 4]
        stages_out = self._CFG[scale]

        input_channels = 3
        output_channels = stages_out[0]
        act_cls = _act_layer(act)
        self.conv1 = nn.Sequential(
            nn.Conv2D(input_channels, output_channels, 3, 2, 1, bias_attr=False),
            nn.BatchNorm2D(output_channels),
            act_cls(),
        )
        input_channels = output_channels
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)

        stage_names = ["stage2", "stage3", "stage4"]
        for name, repeats, output_channels in zip(stage_names, stages_repeats,
                                                  stages_out[1:]):
            seq = [_InvertedResidual(input_channels, output_channels, 2, act)]
            for _ in range(repeats - 1):
                seq.append(_InvertedResidual(output_channels, output_channels, 1, act))
            setattr(self, name, nn.Sequential(*seq))
            input_channels = output_channels

        output_channels = stages_out[-1]
        self.conv5 = nn.Sequential(
            nn.Conv2D(input_channels, output_channels, 1, 1, 0, bias_attr=False),
            nn.BatchNorm2D(output_channels),
            act_cls(),
        )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(output_channels, num_classes)

        self.to(device=resolve_device(device), dtype=dtype)
    def forward(self, x):
        x = self.conv1(x)
        x = self.maxpool(x)
        x = self.stage2(x)
        x = self.stage3(x)
        x = self.stage4(x)
        x = self.conv5(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _shufflenet(scale, pretrained, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (no network egress)")
    return ShuffleNetV2(scale=scale, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained, act="swish", **kwargs)
