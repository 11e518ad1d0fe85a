"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The product is PyTorch's convolution (cuDNN on the card), as the
reference's is XLA's ``lax.conv_general_dilated``: no Pallas kernel runs
there, so no hand-written kernel is owed here.  What is the reference's:

- **padding forms:** an int; one int per spatial dim; a ``2n`` list of
  (lo, hi); nested pairs, of which the last n are taken (paddle's form
  with batch and channel entries); ``"SAME"`` / ``"VALID"``.  ``"SAME"``
  is XLA's rule: ``out = ceil(L / stride)``, the total padding split
  evenly with the extra on the high side, over the dilated kernel.
  Symmetric pads go to PyTorch's own padding; uneven ones are applied by
  ``F.pad`` first (PyTorch's ``padding="same"`` refuses a stride > 1);
- **layouts:** ``NCL`` / ``NCHW`` / ``NCDHW`` and the channels-last
  ``NLC`` / ``NHWC`` / ``NDHWC`` (moved to channels-first around the
  product);
- **dtypes:** a floating input is cast to the weight's dtype, not
  promoted: a bf16 network fed f32 images convolves in bf16.  Under
  ``amp.auto_cast`` the ops are on the white list;
- **transposed convolutions:** the weight is ``(in, out / groups, *k)``,
  ``output_padding`` or ``output_size`` (which implies an
  ``output_padding`` in ``[0, stride)``) set the extra high-side length.
"""

from __future__ import annotations

import torch

from ... import amp

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_T = {1: torch.nn.functional.conv_transpose1d,
           2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(i) for i in v)
    if len(v) == 1:
        return v * n
    return v


def _norm_padding(padding, n):
    """paddle padding -> ``"SAME"`` / ``"VALID"`` or n (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding][-n:]
    raise ValueError(f"bad padding {padding!r}")


def channels_last(data_format):
    return not data_format.startswith("NC")


def to_channels_first(x, data_format):
    return torch.movedim(x, -1, 1) if channels_last(data_format) else x


def from_channels_first(x, data_format):
    return torch.movedim(x, 1, -1) if channels_last(data_format) else x


def same_pairs(sizes, k, s, d=None):
    """XLA's ``"SAME"`` (lo, hi) pairs for spatial ``sizes``, kernel
    ``k``, stride ``s`` and dilation ``d``."""
    pairs = []
    for i, L in enumerate(sizes):
        eff = (d[i] if d else 1) * (k[i] - 1) + 1
        out = -(-L // s[i])
        total = max((out - 1) * s[i] + eff - L, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def pad_pairs(x, pairs, value=0.0):
    """``x`` (channels-first) padded by per-spatial-dim (lo, hi) pairs
    (negative values crop)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat, value=value)


def _input_cast(x, weight, bias, op_name):
    x, weight, bias = amp.cast(op_name, x, weight, bias)
    if x.dtype != weight.dtype and x.is_floating_point() \
            and weight.is_floating_point():
        x = x.to(weight.dtype)
    return x, weight, bias


def _add_bias(out, bias):
    if bias is None:
        return out
    return out + bias.reshape((1, -1) + (1,) * (out.ndim - 2))


def _convnd(x, weight, bias, stride, padding, dilation, groups, data_format,
            n, op_name):
    s = _norm_tuple(stride, n)
    d = _norm_tuple(dilation, n)
    pad = _norm_padding(padding, n)
    x, weight, bias = _input_cast(x, weight, bias, op_name)
    v = to_channels_first(x, data_format)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        pad = same_pairs(v.shape[2:], weight.shape[2:], s, d)
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        v, sym = pad_pairs(v, pad), 0
    # the bias as a separate add, as the reference's: a 16-bit product is
    # rounded before the bias joins, and mixed dtypes promote as in jnp
    out = _add_bias(_CONV[n](v, weight, None, s, sym, d, groups), bias)
    return from_channels_first(out, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n, output_size, op_name):
    s = _norm_tuple(stride, n)
    d = _norm_tuple(dilation, n)
    opad = list(_norm_tuple(output_padding, n))
    pad = _norm_padding(padding, n)
    x, weight, bias = _input_cast(x, weight, bias, op_name)
    v = to_channels_first(x, data_format)
    eff = [d[i] * (weight.shape[2 + i] - 1) + 1 for i in range(n)]
    # the crop (lo, hi) of each dim from the full transposed output
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        pad = [(e - 1 - e // 2, e // 2) for e in eff]
    if output_size is not None:
        tgt = _norm_tuple(output_size, n)
        for i in range(n):
            base = (v.shape[2 + i] - 1) * s[i] + eff[i] - sum(pad[i])
            extra = int(tgt[i]) - base
            if not (0 <= extra < s[i]) and extra != 0:
                raise ValueError(
                    f"conv_transpose output_size {tuple(tgt)} incompatible: "
                    f"dim {i} needs output_padding {extra} outside "
                    f"[0, {s[i]})")
            opad[i] = extra
    if all(lo == hi for lo, hi in pad) and all(
            o < max(s[i], d[i]) for i, o in enumerate(opad)):
        out = _CONV_T[n](v, weight, None, s, tuple(lo for lo, _ in pad),
                         tuple(opad), groups, d)
    else:
        out = _CONV_T[n](v, weight, None, s, 0, 0, groups, d)
        out = pad_pairs(out, [(-lo, -hi + o) for (lo, hi), o in zip(pad, opad)])
    out = from_channels_first(_add_bias(out, bias), data_format)
    if output_size is not None:
        off = 1 if channels_last(data_format) else 2
        cur = tuple(out.shape[off:off + n])
        if cur != tuple(_norm_tuple(output_size, n)):
            raise ValueError(f"conv_transpose output_size {output_size} "
                             f"incompatible with computed {cur}")
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1, output_size,
                           "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2, output_size,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3, output_size,
                           "conv3d_transpose")
