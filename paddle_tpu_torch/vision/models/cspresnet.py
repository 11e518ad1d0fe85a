"""CSPRepResNet backbone and CustomCSPPAN neck, PP-YOLOE's (counterpart of
``paddle_tpu/vision/models/cspresnet.py``).

A ``RepVggBlock`` trains a 3x3 and a 1x1 branch, each conv + BN, and
``convert_to_deploy`` folds both into one 3x3 conv with a bias: the BN
folded in float32 as the reference's numpy does, the new conv on the
block's device and dtype.  The effective-SE gate is paddle's
``hardsigmoid`` (slope 0.1666667, not PyTorch's 1/6).  NCHW throughout;
the convolutions are cuDNN's on the card.  ``CSPRepResNet`` and
``CustomCSPPAN`` take ``device=`` (None: the card, an error without one;
``"cpu"``) and ``dtype=``, their weights drawn on the CPU from torch's
default generator and then moved.
"""

from __future__ import annotations

import torch

from ... import nn
from ...device import resolve_device
from ...nn import functional as F


class ConvBNLayer(torch.nn.Module):
    def __init__(self, ch_in, ch_out, filter_size=3, stride=1, groups=1,
                 padding=0, act="swish"):
        super().__init__()
        self.conv = nn.Conv2D(ch_in, ch_out, filter_size, stride=stride,
                              padding=padding, groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(ch_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "swish":
            x = F.silu(x)
        elif self.act == "relu":
            x = F.relu(x)
        return x


class RepVggBlock(torch.nn.Module):
    """3x3 + 1x1 dual-branch block; ``convert_to_deploy`` folds both convs
    and their BNs into one 3x3 conv, which then holds the state dict key
    ``conv`` (absent before)."""

    def __init__(self, ch_in, ch_out, act="relu"):
        super().__init__()
        self.ch_in = ch_in
        self.ch_out = ch_out
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3, stride=1, padding=1,
                                 act=None)
        self.conv2 = ConvBNLayer(ch_in, ch_out, 1, stride=1, padding=0,
                                 act=None)
        self.act = act
        self.conv = None            # set by convert_to_deploy

    def forward(self, x):
        if self.conv is not None:
            y = self.conv(x)
        else:
            y = self.conv1(x) + self.conv2(x)
        return F.relu(y) if self.act == "relu" else F.silu(y)

    @staticmethod
    def _fuse_conv_bn(branch):
        """(conv W ``[Cout, Cin, k, k]``, BN) -> the equivalent (W', b'),
        in float32 as the reference computes them."""
        w = branch.conv.weight.detach().float()
        bn = branch.bn
        std = torch.sqrt(bn._variance.float() + bn._epsilon)
        scale = bn.weight.detach().float() / std
        w_f = w * scale[:, None, None, None]
        b_f = bn.bias.detach().float() - bn._mean.float() * bn.weight.detach(
        ).float() / std
        return w_f, b_f

    def convert_to_deploy(self):
        w3, b3 = self._fuse_conv_bn(self.conv1)
        w1, b1 = self._fuse_conv_bn(self.conv2)
        w1_p = torch.nn.functional.pad(w1, (1, 1, 1, 1))
        ref = self.conv1.conv.weight
        fused = nn.Conv2D(self.ch_in, self.ch_out, 3, stride=1, padding=1)
        fused.to(device=ref.device, dtype=ref.dtype)
        with torch.no_grad():
            fused.weight.copy_(w3 + w1_p)
            fused.bias.copy_(b3 + b1)
        self.conv = fused
        return self


class EffectiveSELayer(torch.nn.Module):
    """eSE channel attention: ``x * hardsigmoid(fc(mean_hw(x)))``."""

    def __init__(self, channels):
        super().__init__()
        self.fc = nn.Conv2D(channels, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * F.hardsigmoid(self.fc(s))


class BasicBlock(torch.nn.Module):
    def __init__(self, ch_in, ch_out, act="relu", shortcut=True):
        super().__init__()
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3, stride=1, padding=1,
                                 act=act)
        self.conv2 = RepVggBlock(ch_out, ch_out, act=act)
        self.shortcut = shortcut and ch_in == ch_out

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class CSPResStage(torch.nn.Module):
    """Cross-stage-partial stage: downsample, two 1x1 paths, the block
    stack on one, concat, eSE, project."""

    def __init__(self, ch_in, ch_out, n, stride=2, act="relu", attn=True):
        super().__init__()
        ch_mid = (ch_in + ch_out) // 2
        self.conv_down = (ConvBNLayer(ch_in, ch_mid, 3, stride=stride,
                                      padding=1, act=act)
                          if stride != 1 else None)
        if self.conv_down is None:
            ch_mid = ch_in
        self.conv1 = ConvBNLayer(ch_mid, ch_mid // 2, 1, act=act)
        self.conv2 = ConvBNLayer(ch_mid, ch_mid // 2, 1, act=act)
        self.blocks = nn.Sequential(*[
            BasicBlock(ch_mid // 2, ch_mid // 2, act=act, shortcut=True)
            for _ in range(n)])
        self.attn = EffectiveSELayer(ch_mid) if attn else None
        self.conv3 = ConvBNLayer(ch_mid, ch_out, 1, act=act)

    def forward(self, x):
        if self.conv_down is not None:
            x = self.conv_down(x)
        y = torch.cat([self.conv1(x), self.blocks(self.conv2(x))], dim=1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


def _convert_to_deploy(model):
    for m in model.modules():
        if isinstance(m, RepVggBlock):
            m.convert_to_deploy()
    return model


class CSPRepResNet(torch.nn.Module):
    """A stem of three 3x3 convs and four CSP stages; returns the C3 / C4 /
    C5 taps (``return_idx``) for the neck."""

    def __init__(self, layers=(3, 6, 6, 3), channels=(64, 128, 256, 512, 1024),
                 act="swish", return_idx=(1, 2, 3), width_mult=1.0,
                 depth_mult=1.0, device=None, dtype=None):
        super().__init__()
        channels = [max(int(round(c * width_mult)), 16) for c in channels]
        layers = [max(int(round(n * depth_mult)), 1) for n in layers]
        self.stem = nn.Sequential(
            ConvBNLayer(3, channels[0] // 2, 3, stride=2, padding=1, act=act),
            ConvBNLayer(channels[0] // 2, channels[0] // 2, 3, stride=1,
                        padding=1, act=act),
            ConvBNLayer(channels[0] // 2, channels[0], 3, stride=1,
                        padding=1, act=act))
        self.stages = nn.LayerList([
            CSPResStage(channels[i], channels[i + 1], layers[i], stride=2,
                        act=act) for i in range(4)])
        self.return_idx = tuple(return_idx)
        self.out_channels = [channels[i + 1] for i in self.return_idx]
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.return_idx:
                outs.append(x)
        return outs

    def convert_to_deploy(self):
        return _convert_to_deploy(self)


class SPP(torch.nn.Module):
    """Spatial pyramid pooling: stride-1 max pools of sizes ``k`` beside
    the input, concatenated and projected."""

    def __init__(self, ch_in, ch_out, k=(5, 9, 13), act="swish"):
        super().__init__()
        self.pools = [nn.MaxPool2D(kernel_size=kk, stride=1, padding=kk // 2)
                      for kk in k]
        self.conv = ConvBNLayer(ch_in * (len(k) + 1), ch_out, 1, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x] + [p(x) for p in self.pools], dim=1))


class CSPStage(torch.nn.Module):
    """Neck CSP stage: split, a BasicBlock chain (with SPP in its middle
    when asked), concat, project."""

    def __init__(self, ch_in, ch_out, n, act="swish", spp=False):
        super().__init__()
        ch_mid = ch_out // 2
        self.conv1 = ConvBNLayer(ch_in, ch_mid, 1, act=act)
        self.conv2 = ConvBNLayer(ch_in, ch_mid, 1, act=act)
        blocks = []
        for i in range(n):
            blocks.append(BasicBlock(ch_mid, ch_mid, act=act, shortcut=False))
            if i == (n - 1) // 2 and spp:
                blocks.append(SPP(ch_mid, ch_mid, act=act))
        self.blocks = nn.Sequential(*blocks)
        self.conv3 = ConvBNLayer(ch_mid * 2, ch_out, 1, act=act)

    def forward(self, x):
        return self.conv3(torch.cat([self.conv1(x),
                                     self.blocks(self.conv2(x))], dim=1))


class CustomCSPPAN(torch.nn.Module):
    """PP-YOLOE's neck: a top-down FPN then a bottom-up PAN, a CSPStage at
    every junction, SPP on the deepest level; the outputs finest first.
    The top-down path upsamples by ``interpolate(size=...)``, nearest
    (the reference's ``floor((i + 0.5) * in / out)``)."""

    def __init__(self, in_channels, out_channels=(768, 384, 192), act="swish",
                 stage_num=1, block_num=3, spp=True, device=None, dtype=None):
        super().__init__()
        out_channels = list(out_channels)
        self.fpn_stages = nn.LayerList()
        self.fpn_routes = nn.LayerList()
        ch_pre = 0
        n_levels = len(in_channels)
        for i, (ch_in, ch_out) in enumerate(zip(in_channels[::-1],
                                                out_channels)):
            cin = ch_in + (ch_pre // 2 if i > 0 else 0)
            self.fpn_stages.append(CSPStage(cin, ch_out, block_num, act=act,
                                            spp=spp and i == 0))
            if i < n_levels - 1:
                self.fpn_routes.append(
                    ConvBNLayer(ch_out, ch_out // 2, 1, act=act))
            ch_pre = ch_out
        self.pan_stages = nn.LayerList()
        self.pan_routes = nn.LayerList()
        for i in range(n_levels - 1):
            ch_low = out_channels[n_levels - 1 - i]     # finer level
            ch_high = out_channels[n_levels - 2 - i]    # coarser target
            self.pan_routes.append(
                ConvBNLayer(ch_low, ch_low, 3, stride=2, padding=1, act=act))
            self.pan_stages.append(
                CSPStage(ch_low + ch_high, ch_high, block_num, act=act))
        self.out_channels = out_channels[::-1]
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, feats):
        fpn_feats = []
        route = None
        for i, feat in enumerate(feats[::-1]):
            if i > 0:
                up = F.interpolate(route, size=feat.shape[2:], mode="nearest")
                feat = torch.cat([up, feat], dim=1)
            feat = self.fpn_stages[i](feat)
            fpn_feats.append(feat)
            if i < len(feats) - 1:
                route = self.fpn_routes[i](feat)
        pan_feats = [fpn_feats[-1]]
        route = fpn_feats[-1]
        for i in range(len(feats) - 1):
            down = self.pan_routes[i](route)
            block = fpn_feats[len(feats) - 2 - i]
            route = self.pan_stages[i](torch.cat([down, block], dim=1))
            pan_feats.append(route)
        return pan_feats
