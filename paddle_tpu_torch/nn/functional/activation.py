"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch

from ... import amp


def gelu(x, approximate=False):
    """GELU; the exact erf form unless ``approximate`` (then tanh), as
    ``jax.nn.gelu(approximate=...)``."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def swish(x):
    """``x * sigmoid(x)`` (``jax.nn.silu``); under ``amp.auto_cast`` at O2
    it runs in the amp dtype."""
    x, = amp.cast("swish", x)
    return torch.nn.functional.silu(x)


silu = swish


def relu(x, name=None):
    """``max(x, 0)``; under ``amp.auto_cast`` at O2 in the amp dtype."""
    x, = amp.cast("relu", x)
    return torch.relu(x)


def tanh(x, name=None):
    """``tanh(x)``; under ``amp.auto_cast`` at O2 in the amp dtype."""
    x, = amp.cast("tanh", x)
    return torch.tanh(x)
