"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``dropout``, ``embedding`` and ``one_hot``, the parts the high-level API
and BERT call."""

from __future__ import annotations

import torch

from ... import amp


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout with paddle's modes: ``"upscale_in_train"`` keeps each
    element with probability ``1 - p`` and scales it by ``1 / (1 - p)``;
    ``"downscale_in_infer"`` keeps it unscaled in training and scales by
    ``1 - p`` in inference.  ``axis`` (an int or a list) draws one keep
    decision per index of those dims, shared along the others.  The mask
    comes from torch's default generator of ``x``'s device, not the TPU
    package's key; the plain form (no ``axis``, upscale_in_train) is
    torch's own fused dropout."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p != 0.0:
            return (x * (1.0 - p)).to(x.dtype)
        return x
    if axis is None and mode == "upscale_in_train":
        return torch.nn.functional.dropout(x, min(p, 1.0))
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.ndim for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        if p >= 1.0:
            return x * zero
        return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    return torch.where(keep, x, zero)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; wherever ``x == padding_idx`` the
    output is zero, whatever that row holds, so no gradient reaches the
    row from those positions (the TPU package's rule; torch's own
    ``padding_idx`` returns the row's contents)."""
    w, = amp.cast("embedding", weight)
    out = torch.nn.functional.embedding(x.long(), w)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def one_hot(x, num_classes, name=None):
    """float32 one-hot of the int tensor ``x`` over ``num_classes``."""
    return torch.nn.functional.one_hot(x.long(), num_classes).float()
