"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch


def gelu(x, approximate=False):
    """GELU; the exact erf form unless ``approximate`` (then tanh), as
    ``jax.nn.gelu(approximate=...)``."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")
