"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

from ... import amp


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last dim: the mean square in f32, the normalised
    value cast back to x's dtype, then times ``weight`` under the usual
    type promotion (a bf16 weight times an f32 x gives f32, as in jnp).
    Under ``amp.auto_cast`` at O2 it runs in the amp dtype."""
    x, weight = amp.cast("rms_norm", x, weight)
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
