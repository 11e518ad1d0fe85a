"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``)."""

from __future__ import annotations

import torch

from ... import amp
from ..functional.norm import rms_norm


class LayerNorm(torch.nn.Module):
    """Layer norm over the last dims with the TPU package's numerics:
    statistics in f32, the normalised value cast back to the input dtype
    before the affine, which runs in the input dtype.  Under
    ``amp.auto_cast`` at O2 it runs in the amp dtype (O1 leaves it)."""

    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(torch.ones(self.normalized_shape))
        self.bias = torch.nn.Parameter(torch.zeros(self.normalized_shape))

    def forward(self, x):
        x, weight, bias = amp.cast("layer_norm", x, self.weight, self.bias)
        dims = tuple(range(x.ndim - len(self.normalized_shape), x.ndim))
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
        out = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        return out * weight.to(x.dtype) + bias.to(x.dtype)


class RMSNorm(torch.nn.Module):
    """RMSNorm over the last dim (:func:`..functional.norm.rms_norm`), its
    weight all ones."""

    def __init__(self, hidden_size, epsilon=1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
