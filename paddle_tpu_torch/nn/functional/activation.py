"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Each is the reference's formula (the ``jax.nn`` one where the reference
calls ``jax.nn``), in the input's dtype.  Under ``amp.auto_cast`` the
input is cast for the op's name (O2: the amp dtype; ``softmax`` /
``log_softmax`` are on the black list: float32).  The random ones
(``rrelu``, ``gumbel_softmax``) draw from ``generator`` (torch's default
generator of the input's device when None), where the reference draws
from its framework key.
"""

from __future__ import annotations

import torch

from ... import amp

_F = torch.nn.functional


def _cast(name, x):
    return amp.cast(name, x)[0]


def gelu(x, approximate=False, name=None):
    """GELU; the exact erf form unless ``approximate`` (then tanh), as
    ``jax.nn.gelu(approximate=...)``."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def swish(x, name=None):
    """``x * sigmoid(x)`` (``jax.nn.silu``); under ``amp.auto_cast`` at O2
    it runs in the amp dtype."""
    x, = amp.cast("swish", x)
    return torch.nn.functional.silu(x)


silu = swish


def relu(x, name=None):
    """``max(x, 0)``; under ``amp.auto_cast`` at O2 in the amp dtype."""
    x, = amp.cast("relu", x)
    return torch.relu(x)


def relu_(x):
    """In-place ``relu``."""
    return torch.relu_(x)


def tanh(x, name=None):
    """``tanh(x)``; under ``amp.auto_cast`` at O2 in the amp dtype."""
    x, = amp.cast("tanh", x)
    return torch.tanh(x)


def relu6(x, name=None):
    return torch.clamp(_cast("relu6", x), 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    x = _cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = _cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x = _cast("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def leaky_relu(x, negative_slope=0.01, name=None):
    x = _cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one slope, or one per
    channel (axis 1, or the last axis for a channels-last format)."""
    x, weight = amp.cast("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format.startswith("NC") else x.ndim - 1] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.333, training=True, name=None,
          generator=None):
    """``x`` where ``x >= 0``, else ``a * x``: ``a`` uniform in [lower,
    upper) per element in training, ``(lower + upper) / 2`` otherwise."""
    x = _cast("rrelu", x)
    if training:
        a = lower + (upper - lower) * torch.rand(
            x.shape, generator=generator, device=x.device, dtype=torch.float32)
        a = a.to(x.dtype)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def sigmoid(x, name=None):
    return torch.sigmoid(_cast("sigmoid", x))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * _cast("hardsigmoid", x) + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x = _cast("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(_cast("hardtanh", x), min, max)


def hardshrink(x, threshold=0.5, name=None):
    x = _cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x = _cast("softshrink", x)
    return torch.sign(x) * torch.clamp(x.abs() - threshold, min=0.0)


def log_sigmoid(x, name=None):
    return _F.logsigmoid(_cast("log_sigmoid", x))


def _dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def softmax(x, axis=-1, dtype=None, name=None):
    x = _cast("softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.softmax(x, dim=axis)


softmax_ = softmax


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = _cast("log_softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    x = _cast("softplus", x)
    soft = (1.0 / beta) * torch.log1p(torch.exp(
        beta * torch.clamp(x, max=threshold / beta)))
    return torch.where(beta * x > threshold, x, soft)


def softsign(x, name=None):
    x = _cast("softsign", x)
    return x / (1 + x.abs())


def mish(x, name=None):
    x = _cast("mish", x)
    return x * torch.tanh(_F.softplus(x))


def tanhshrink(x, name=None):
    x = _cast("tanhshrink", x)
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    x = _cast("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


def maxout(x, groups, axis=1, name=None):
    x = _cast("maxout", x)
    ax = axis % x.ndim
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax + 1)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(_cast("glu", x), 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """Softmax of ``(x + g) / temperature``, ``g`` standard Gumbel noise;
    ``hard`` returns the one-hot of the argmax with the soft gradient
    (straight-through)."""
    x = _cast("gumbel_softmax", x)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32).clamp(min=torch.finfo(
                       torch.float32).tiny)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y
