"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` (paddle's ``[in, out]`` weight), the dropout family,
``embedding``, ``one_hot``, ``pad`` (with paddle's ``data_format`` rule),
``channel_shuffle``, ``interpolate`` (``jax.image.resize``'s rules, not
PyTorch's), pixel (un)shuffle, (un)fold, ``grid_sample`` /
``affine_grid``, ``bilinear``, the distances, ``label_smooth`` and
``sequence_mask``.  ``class_center_sample`` raises in the reference and is
not ported."""

from __future__ import annotations

import numpy as np
import torch

from ... import amp


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout with paddle's modes: ``"upscale_in_train"`` keeps each
    element with probability ``1 - p`` and scales it by ``1 / (1 - p)``;
    ``"downscale_in_infer"`` keeps it unscaled in training and scales by
    ``1 - p`` in inference.  ``axis`` (an int or a list) draws one keep
    decision per index of those dims, shared along the others.  The mask
    comes from ``generator`` (torch's default generator of ``x``'s device
    when None), not the TPU package's key; the plain form (no ``axis``,
    upscale_in_train, no ``generator``) is torch's own fused dropout."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p != 0.0:
            return (x * (1.0 - p)).to(x.dtype)
        return x
    if axis is None and mode == "upscale_in_train" and generator is None:
        return torch.nn.functional.dropout(x, min(p, 1.0))
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.ndim for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(shape, p, x.device, generator)
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


def _keep_mask(shape, p, device, generator):
    """Bernoulli(1 - p) keep decisions of ``shape`` from ``generator``
    (torch's default generator of ``device`` when None)."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels dropped: one keep decision per (N, C), as the
    reference's ``dropout(axis=[0, 1])`` (``[0, 3]`` for NHWC)."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training, generator=generator)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _alpha_dropout(x, p, mask_shape, generator):
    keep = _keep_mask(mask_shape, p, x.device, generator)
    a_prime = -_SELU_ALPHA * _SELU_SCALE
    a = ((1 - p) * (1 + p * a_prime ** 2)) ** -0.5
    b = -a * a_prime * p
    fill = torch.full((), a_prime, dtype=x.dtype, device=x.device)
    return (a * torch.where(keep, x, fill) + b).to(x.dtype)


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU-preserving dropout: dropped elements take ``-alpha * scale``,
    then ``a * v + b`` restores the mean and variance (the reference's
    constants)."""
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, p, tuple(x.shape), generator)


def feature_alpha_dropout(x, p=0.5, training=True, generator=None):
    """:func:`alpha_dropout` with one decision per feature map ``[N, C]``
    (the reference's ``FeatureAlphaDropout``)."""
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, p, tuple(x.shape[:2]) + (1,) * (x.ndim - 2),
                          generator)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = (x1 * x2).sum(axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``(sum |x - y + epsilon|^p) ^ (1 / p)`` over the last dim."""
    d = x - y + epsilon
    return (d.abs() ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


# ------------------------------------------------------------- interpolate
_RESAMPLE = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
             "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def _triangle(d):
    return torch.clamp(1 - d.abs(), min=0)


def _keys_cubic(d):
    """Keys' cubic, a = -0.5 (``jax.image.resize``'s kernel)."""
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _weight_mat(n_in, n_out, kernel, device):
    """``[n_in, n_out]`` antialiased resampling weights, computed in
    float32 as ``jax.image.resize`` computes them: half-pixel sample
    positions, the kernel widened by the downsampling factor, each column
    normalised over the taps inside the input, columns whose sample lies
    outside the input zero."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.5
    d = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = kernel(d)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _linspace_f32(stop, num):
    """``jnp.linspace(0, stop, num, dtype=float32)`` value for value:
    ``stop * (i / (num - 1))``, the last exactly ``stop``."""
    if num == 1:
        return torch.zeros(1)
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([stop * step, torch.tensor([float(stop)])])


def _resize_align_corners(v, axes, tgt, cubic):
    """The reference's endpoint-aligned resampling, one axis at a time:
    source positions ``linspace(0, in - 1, out)`` in float32; linear
    between the two neighbours, or Keys' cubic with a = -0.75 over four
    taps clamped into the input; the weights in ``v``'s dtype."""
    out = v
    for ax, t in zip(axes, tgt):
        n_in = out.shape[ax]
        idx = torch.zeros(t) if t == 1 or n_in == 1 \
            else _linspace_f32(n_in - 1, t)
        idx = idx.to(v.device)
        shape = [1] * out.ndim
        shape[ax] = t
        base = torch.floor(idx).long()
        frac = (idx - base).to(v.dtype)
        if cubic:
            A = -0.75
            acc = 0.0
            for tap in (-1, 0, 1, 2):
                d = (frac - tap).abs()
                w = torch.where(
                    d <= 1, ((A + 2) * d - (A + 3)) * d * d + 1,
                    torch.where(d < 2, ((A * d - 5 * A) * d + 8 * A) * d
                                - 4 * A, torch.zeros_like(d)))
                src = torch.clamp(base + tap, 0, n_in - 1)
                acc = acc + out.index_select(ax, src) * w.reshape(shape)
            out = acc
        else:
            hi = torch.clamp(base + 1, 0, n_in - 1)
            wb = frac.reshape(shape)
            out = out.index_select(ax, base) * (1 - wb) + \
                out.index_select(ax, hi) * wb
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims of ``x`` (3-d, 4-d or 5-d; channels first
    when ``data_format`` starts with ``"NC"``) as the reference's
    ``jax.image.resize`` does, not as ``torch.nn.functional.interpolate``:

    - the output size is ``size``, else ``int(in * scale_factor)``; a dim
      whose size does not change is left as it is;
    - ``"nearest"`` takes source ``floor((i + 0.5) * in / out)`` in
      float32 (PyTorch's ``"nearest-exact"``, not its ``"nearest"``);
    - ``"linear"`` / ``"bilinear"`` / ``"trilinear"`` / ``"area"`` (the
      reference maps ``area`` to linear) and ``"bicubic"`` (Keys, a =
      -0.5) resample with antialiasing when downsampling: one float32
      weight matrix per dim (:func:`_weight_mat`), cast to ``x``'s dtype
      and contracted dim by dim in it, so a bfloat16 ``x`` computes in
      bfloat16 with bfloat16 weights, each contraction rounded, as
      ``jax.image.resize`` casts its weights to the input's dtype;
    - ``align_corners=True`` (not nearest) runs the reference's own
      loop (:func:`_resize_align_corners`).
    ``align_mode`` is accepted and not read, as in the reference."""
    nd = x.ndim
    axes = list(range(2, nd)) if data_format.startswith("NC") \
        else list(range(1, nd - 1))
    if size is not None:
        tgt = [int(s) for s in (size if isinstance(size, (list, tuple,
                                                          torch.Size))
                                else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(axes)
        tgt = [int(x.shape[ax] * f) for ax, f in zip(axes, sf)]
    kind = _RESAMPLE[mode]
    if align_corners and kind != "nearest":
        return _resize_align_corners(x, axes, tgt, kind == "cubic")
    changed = [(ax, t) for ax, t in zip(axes, tgt) if x.shape[ax] != t]
    out = x
    if kind == "nearest":
        for ax, t in changed:
            m = out.shape[ax]
            src = torch.floor((torch.arange(t, dtype=torch.float32) + 0.5)
                              * m / t).long()
            out = out.index_select(ax, src.to(x.device))
        return out
    if not out.is_floating_point():
        out = out.float()
    kernel = _keys_cubic if kind == "cubic" else _triangle
    for ax, t in changed:
        w = _weight_mat(out.shape[ax], t, kernel, x.device).to(out.dtype)
        out = torch.movedim(torch.movedim(out, ax, -1) @ w, -1, ax)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    out = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """NCHW only, as the reference (NHWC raises ``NotImplementedError``)."""
    r = downscale_factor
    if data_format != "NCHW":
        raise NotImplementedError
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return out.reshape(n, c * r * r, h // r, w // r)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C * kh * kw, L]`` (channel-major, as the reference).
    ``paddings``: an int, ``[ph, pw]``, or ``[top, left, bottom, right]``
    (the reference reads the four as H (0, 2) and W (1, 3))."""
    if isinstance(paddings, int):
        pads = (paddings, paddings, paddings, paddings)       # l r t b
    else:
        pl = list(paddings)
        pads = (pl[1], pl[1], pl[0], pl[0]) if len(pl) == 2 \
            else (pl[1], pl[3], pl[0], pl[2])
    x = torch.nn.functional.pad(x, pads)
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      dilation=_pair(dilations),
                                      stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of :func:`unfold` (overlaps summed).  A list of
    ``paddings`` gives H's and W's from its first two entries, as the
    reference reads it."""
    p = _pair(paddings) if isinstance(paddings, int) \
        else (list(paddings)[0], list(paddings)[1])
    return torch.nn.functional.fold(x, _pair(output_sizes),
                                    _pair(kernel_sizes),
                                    dilation=_pair(dilations), padding=p,
                                    stride=_pair(strides))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``, weight
    ``[out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """The reference's bilinear sampling (``mode`` is not read): ``grid``
    ``[N, gh, gw, 2]`` in [-1, 1]; with ``"zeros"`` a corner outside the
    input contributes 0, any other ``padding_mode`` clamps the corner
    into it.  Gradients reach ``x`` and ``grid``."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1) * (w - 1) / 2
        iy = (gy + 1) * (h - 1) / 2
    else:
        ix = ((gx + 1) * w - 1) / 2
        iy = ((gy + 1) * h - 1) / 2
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1_, y1_ = x0 + 1, y0 + 1
    v = x.permute(0, 2, 3, 1)
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(xi, yi):
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        out = v[bidx, yc, xc]                       # (n, gh, gw, c)
        if padding_mode == "zeros":
            valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                     & (yi <= h - 1))[..., None]
            out = torch.where(valid, out, torch.zeros_like(out))
        return out

    wa = ((x1_ - ix) * (y1_ - iy))[..., None]
    wb = ((x1_ - ix) * (iy - y0))[..., None]
    wc = ((ix - x0) * (y1_ - iy))[..., None]
    wd = ((ix - x0) * (iy - y0))[..., None]
    out = (sample(x0, y0) * wa + sample(x0, y1_) * wb
           + sample(x1_, y0) * wc + sample(x1_, y1_) * wd)
    return out.permute(0, 3, 1, 2)


def _linspace_sym(num, dtype, device):
    """``jnp.linspace(-1, 1, num)``: ``-1 * (1 - s) + s``, ``s = i / (num -
    1)``, the last exactly 1."""
    if num == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    s = torch.arange(num - 1, dtype=dtype, device=device) / (num - 1)
    return torch.cat([-1.0 * (1 - s) + s,
                      torch.ones(1, dtype=dtype, device=device)])


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, H, W, 2]`` sampling grid of the affine maps ``theta`` ``[N,
    2, 3]`` over an ``out_shape`` ``[N, C, H, W]`` output."""
    h, w = int(out_shape[2]), int(out_shape[3])
    dt, dev = theta.dtype, theta.device
    if align_corners:
        xs, ys = _linspace_sym(w, dt, dev), _linspace_sym(h, dt, dev)
    else:
        xs = ((torch.arange(w, device=dev) * 2 + 1) / w - 1).to(dt)
        ys = ((torch.arange(h, device=dev) * 2 + 1) / h - 1).to(dt)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # (h, w, 3)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]`` over ``maxlen`` (the longest
    length when None) columns, in ``dtype``."""
    m = int(maxlen) if maxlen is not None else int(lengths.max())
    mask = torch.arange(m, device=lengths.device) < lengths[..., None]
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch,
                                                              str(dtype))
    return mask.to(dt)
