"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` (paddle's ``[in, out]`` weight), ``dropout``, ``embedding``,
``one_hot``, ``pad`` (with paddle's ``data_format`` rule) and
``channel_shuffle``."""

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


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with paddle's ``[in_features, out_features]``
    weight; under ``amp.auto_cast`` in the amp dtype (white list)."""
    from ..layers.common import promote

    x, weight, bias = promote(*amp.cast("linear", x, weight, bias))
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's ``F.pad``: ``pad`` of ``2 * ndim`` ints gives (lo, hi) for
    every dim in order; a shorter list pads the last ``len(pad) // 2``
    spatial dims, its first pair on the last spatial dim (channels-first
    formats) or on the spatial dim before the channels (channels-last).
    ``mode``: ``"constant"`` (``value``), ``"reflect"``, ``"replicate"``
    or ``"circular"``."""
    p = [int(v) for v in (pad.tolist() if isinstance(pad, torch.Tensor)
                          else pad)]
    nd = x.ndim
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        k = len(p) // 2
        width = [(0, 0)] * nd
        dims = list(range(nd - k, nd)) if data_format in ("NCHW", "NCL",
                                                          "NCDHW") \
            else list(range(1, 1 + k))
        for j, d in enumerate(reversed(dims)):
            width[d] = (p[2 * j], p[2 * j + 1])
    if mode == "constant":
        flat = [v for lo_hi in reversed(width) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    # PyTorch pads only the trailing 1-3 dims in these modes: move the
    # padded dims last, fold the others into one, pad, and move back
    padded = [d for d in range(nd) if width[d] != (0, 0)]
    if not 1 <= len(padded) <= 3:
        raise ValueError(f"pad mode {mode!r} pads 1 to 3 dims, got {width}")
    perm = [d for d in range(nd) if d not in padded] + padded
    v = x.permute(perm)
    lead = tuple(v.shape[:nd - len(padded)])
    v = v.reshape((-1,) + tuple(v.shape[nd - len(padded):]))
    flat = [e for d in reversed(padded) for e in width[d]]
    out = torch.nn.functional.pad(v, flat, mode=mode)
    out = out.reshape(lead + tuple(out.shape[1:]))
    return out.permute([perm.index(d) for d in range(nd)])


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """``[N, C, H, W]``: the channels as ``groups`` x ``C / groups``,
    transposed."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)
