"""Activation layers (counterpart of ``paddle_tpu/nn/layers/activation.py``).

Each layer keeps its constructor's arguments and calls its
:mod:`..functional.activation` function with them, as the reference's
``_simple`` layers do (so ``RReLU`` draws its slopes whatever the
training flag, as there).  ``PReLU``'s ``weight`` starts at ``init``;
``Softmax2D`` is the softmax over the channel axis (-3).
"""

from __future__ import annotations

import torch

from .. import functional as F
from .common import make_parameter


def _simple(name, fname=None):
    fn = getattr(F, fname or name.lower())

    class _Act(torch.nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop("name", None)
            self._args, self._kwargs = args, kwargs

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU")
ReLU6 = _simple("ReLU6")
ELU = _simple("ELU")
SELU = _simple("SELU")
CELU = _simple("CELU")
GELU = _simple("GELU")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
Sigmoid = _simple("Sigmoid")
Hardsigmoid = _simple("Hardsigmoid")
Hardswish = _simple("Hardswish")
Hardtanh = _simple("Hardtanh")
Hardshrink = _simple("Hardshrink")
Softshrink = _simple("Softshrink")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Softplus = _simple("Softplus")
Softsign = _simple("Softsign")
Swish = _simple("Swish")
Silu = _simple("Silu")
Mish = _simple("Mish")
Tanh = _simple("Tanh")
Tanhshrink = _simple("Tanhshrink")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
Softmax = _simple("Softmax")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
Maxout = _simple("Maxout")
GLU = _simple("GLU")
RReLU = _simple("RReLU", "rrelu")


class PReLU(torch.nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = make_parameter([num_parameters], weight_attr, init)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softmax2D(torch.nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softmax(x, axis=-3)
