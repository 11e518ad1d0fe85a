"""Convolution layers (counterpart of ``paddle_tpu/nn/layers/conv.py``).

The weight keeps paddle's layout, ``[out, in / groups, *k]`` (the
transposed layers ``[in, out / groups, *k]``), which is PyTorch's too, so
``text.models.convert`` does not transpose it.  Default initialisation is
the reference's: ``KaimingUniform(fan_in)`` for the weight and
``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))`` for the bias, with
``fan_in = in / groups * prod(k)``, drawn from torch's default generator
(``paddle_tpu_torch.seed`` seeds it); ``weight_attr`` / ``bias_attr`` as
in :func:`.common.make_parameter`.  ``padding_mode`` is accepted and not
read, as in the reference.
"""

from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from .common import make_parameter


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(torch.nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        self.padding_mode = padding_mode
        self.output_padding = output_padding
        if transpose:
            wshape = [in_channels, out_channels // groups] + list(self.kernel_size)
        else:
            wshape = [out_channels, in_channels // groups] + list(self.kernel_size)
        fan_in = in_channels // groups * int(math.prod(self.kernel_size))
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = make_parameter(wshape, weight_attr,
                                     I.KaimingUniform(fan_in=fan_in))
        self.bias = make_parameter([out_channels], bias_attr,
                                   I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)
