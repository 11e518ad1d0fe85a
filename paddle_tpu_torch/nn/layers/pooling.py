"""Pooling layers (counterpart of ``paddle_tpu/nn/layers/pooling.py``),
each over its :mod:`..functional.pooling` function with the reference's
argument order.  ``FractionalMaxPool2D`` / ``3D`` fix their region offset
at construction: ``random_u``, or one draw from ``generator`` (torch's
default generator when None) where the reference draws from its
framework stream."""

from __future__ import annotations

import torch

from .. import functional as F
from ..functional.pooling import draw_fractional_u


class _Pool(torch.nn.Module):
    def __init__(self, fname, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        kw.pop("name", None)
        self._fn = getattr(F, fname)
        self._args = dict(kernel_size=kernel_size, stride=stride, padding=padding, **kw)

    def forward(self, x):
        return self._fn(x, **self._args)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__("max_pool1d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__("max_pool2d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__("max_pool3d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__("avg_pool1d", kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__("avg_pool2d", kernel_size, stride, padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__("avg_pool3d", kernel_size, stride, padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, divisor_override=divisor_override,
                         data_format=data_format)


class _AdaptivePool(torch.nn.Module):
    def __init__(self, fname, output_size, **kw):
        super().__init__()
        kw.pop("name", None)
        self._fn = getattr(F, fname)
        self._output_size = output_size
        self._kw = kw

    def forward(self, x):
        return self._fn(x, self._output_size, **self._kw)


class AdaptiveAvgPool1D(_AdaptivePool):
    def __init__(self, output_size, name=None):
        super().__init__("adaptive_avg_pool1d", output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__("adaptive_avg_pool2d", output_size, data_format=data_format)


class AdaptiveAvgPool3D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__("adaptive_avg_pool3d", output_size, data_format=data_format)


class AdaptiveMaxPool1D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool1d", output_size, return_mask=return_mask)


class AdaptiveMaxPool2D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool2d", output_size, return_mask=return_mask)


class AdaptiveMaxPool3D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__("adaptive_max_pool3d", output_size, return_mask=return_mask)


class MaxUnPool1D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format)
        self.output_size = output_size

    def forward(self, x, indices):
        k, s, p, df = self.args
        return F.max_unpool1d(x, indices, k, stride=s, padding=p,
                              data_format=df, output_size=self.output_size)


class MaxUnPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format)
        self.output_size = output_size

    def forward(self, x, indices):
        k, s, p, df = self.args
        return F.max_unpool2d(x, indices, k, stride=s, padding=p,
                              data_format=df, output_size=self.output_size)


class MaxUnPool3D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format)
        self.output_size = output_size

    def forward(self, x, indices):
        k, s, p, df = self.args
        return F.max_unpool3d(x, indices, k, stride=s, padding=p,
                              data_format=df, output_size=self.output_size)


class LPPool1D(torch.nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        nt, k, s, p, cm, df = self.args
        return F.lp_pool1d(x, nt, k, stride=s, padding=p, ceil_mode=cm,
                           data_format=df)


class LPPool2D(torch.nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        nt, k, s, p, cm, df = self.args
        return F.lp_pool2d(x, nt, k, stride=s, padding=p, ceil_mode=cm,
                           data_format=df)


class FractionalMaxPool2D(torch.nn.Module):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None, generator=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.return_mask = return_mask
        self.random_u = random_u if random_u is not None \
            else draw_fractional_u(generator)

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size, self.kernel_size,
                                       self.random_u, self.return_mask)


class FractionalMaxPool3D(torch.nn.Module):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None, generator=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.return_mask = return_mask
        self.random_u = random_u if random_u is not None \
            else draw_fractional_u(generator)

    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size, self.kernel_size,
                                       self.random_u, self.return_mask)
