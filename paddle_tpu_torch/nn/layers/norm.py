"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``):
``LayerNorm``, ``RMSNorm`` and ``SpectralNorm``."""

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


class SpectralNorm(torch.nn.Module):
    """``weight / sigma``, ``sigma`` the largest singular value of
    ``weight`` seen as a ``[shape[dim], -1]`` matrix, estimated by
    ``power_iters`` rounds of power iteration from the ``weight_u`` /
    ``weight_v`` buffers (drawn N(0, 1) at construction and never written,
    as in the reference; the gradient flows through the iteration)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.register_buffer("weight_u", torch.randn(h, dtype=dtype))
        self.register_buffer("weight_v", torch.randn(w, dtype=dtype))

    def forward(self, weight):
        dim, eps = self._dim, self._eps
        wm = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        sigma = u @ wm @ v
        return weight / sigma
