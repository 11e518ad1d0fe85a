"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference reduces windows with ``lax.reduce_window``; here PyTorch's
pooling ops do, with the reference's rules:

- padding takes the conv forms (``_norm_padding``); ``"SAME"`` is XLA's
  rule; max pooling pads with ``-inf``, sums with 0;
- ``ceil_mode`` keeps the last partial window, but a window that would
  start wholly in the right padding is dropped (``_resolve_pad``);
- ``exclusive=True`` (the default) divides an average by the count of
  elements that are not padding; ``exclusive=False`` by the window size.
  As in the reference, string padding without ``ceil_mode`` divides by
  the window size either way;
- the pads are applied by ``F.pad`` (``-inf`` for max pooling, 0 for
  sums) and PyTorch's op pools the padded tensor unpadded; an exclusive
  average divides by the pooled count of a padded ones tensor.  The
  gradient of a max pool goes to the first maximum of each window, as
  XLA's ``select_and_scatter`` does;
- ``return_mask`` gives the flat index of each window's first maximum in
  the unpadded spatial volume; ``max_unpool*`` scatters back;
- adaptive pooling bins are ``[floor(i * in / out), ceil((i + 1) * in /
  out))``; ``adaptive_max_pool*`` accepts ``return_mask`` and, as the
  reference, returns the pooled values only;
- ``fractional_max_pool*`` pools the disjoint regions of Graham's
  sequence; without ``random_u`` its offset is drawn from ``generator``
  (torch's default generator when None), where the reference draws from
  its framework stream.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ... import amp
from .conv import (_norm_padding, _norm_tuple, from_channels_first,
                   pad_pairs, same_pairs, to_channels_first)

_MAX = {1: torch.nn.functional.max_pool1d, 2: torch.nn.functional.max_pool2d,
        3: torch.nn.functional.max_pool3d}
_AVG = {1: torch.nn.functional.avg_pool1d, 2: torch.nn.functional.avg_pool2d,
        3: torch.nn.functional.avg_pool3d}


def _resolve_pad(pad, spatial, k, s, ceil_mode=False):
    """Concrete per-dim (lo, hi) pairs; ``ceil_mode`` extends hi so the
    last partial window is kept (unless it would start in the padding)."""
    n = len(spatial)
    if isinstance(pad, str):
        pairs = [(0, 0)] * n if pad == "VALID" else same_pairs(spatial, k, s)
    else:
        pairs = [tuple(pp) for pp in pad]
    if ceil_mode:
        adj = []
        for i in range(n):
            lo, hi = pairs[i]
            L = spatial[i]
            out = -(-(L + lo + hi - k[i]) // s[i]) + 1
            if (out - 1) * s[i] >= L + lo:
                out -= 1
            adj.append((lo, max((out - 1) * s[i] + k[i] - L - lo, 0)))
        pairs = adj
    return pairs


def _pool(x, kernel_size, stride, padding, n, data_format, kind,
          ceil_mode=False, exclusive=True):
    k = _norm_tuple(kernel_size, n)
    s = _norm_tuple(stride if stride is not None else kernel_size, n)
    pad = _norm_padding(padding, n)
    x, = amp.cast(f"{kind}_pool{n}d", x)
    v = to_channels_first(x, data_format)
    spatial = tuple(v.shape[2:])
    pairs = _resolve_pad(pad, spatial, k, s, ceil_mode)
    # string padding without ceil_mode divides by the window size
    exclusive = exclusive and not (isinstance(pad, str) and not ceil_mode)
    if kind == "max":
        out = _MAX[n](pad_pairs(v, pairs, float("-inf")), k, s)
    elif exclusive:
        summed = _AVG[n](pad_pairs(v, pairs), k, s) * math.prod(k)
        ones = torch.ones((1, 1) + spatial, dtype=v.dtype, device=v.device)
        out = summed / (_AVG[n](pad_pairs(ones, pairs), k, s) * math.prod(k))
    else:
        out = _AVG[n](pad_pairs(v, pairs), k, s)
    return from_channels_first(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    out = _pool(x, kernel_size, stride, padding, 1, data_format, "max",
                ceil_mode)
    return (out, _pool_mask(x, kernel_size, stride, padding, 1, data_format,
                            ceil_mode)) if return_mask else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                ceil_mode)
    return (out, _pool_mask(x, kernel_size, stride, padding, 2, data_format,
                            ceil_mode)) if return_mask else out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                ceil_mode)
    return (out, _pool_mask(x, kernel_size, stride, padding, 3, data_format,
                            ceil_mode)) if return_mask else out


def _pool_mask(x, kernel_size, stride, padding, n, data_format,
               ceil_mode=False):
    """Flat index of each window's first maximum into the input's spatial
    volume (int32; padded taps never win unless the window is all
    padding, and then they read -1)."""
    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise NotImplementedError("return_mask expects channel-first layout")
    k = _norm_tuple(kernel_size, n)
    s = _norm_tuple(stride if stride is not None else kernel_size, n)
    pad = _norm_padding(padding, n)
    spatial = tuple(x.shape[2:])
    pairs = _resolve_pad(pad, spatial, k, s, ceil_mode)
    fill = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    padded = pad_pairs(x, pairs, fill)
    pos = pad_pairs(torch.arange(math.prod(spatial), device=x.device)
                    .reshape((1, 1) + spatial), pairs, -1)[0, 0]
    out_sp = [(spatial[i] + sum(pairs[i]) - k[i]) // s[i] + 1
              for i in range(n)]
    vals, idxs = [], []
    for offs in itertools.product(*[range(kk) for kk in k]):
        sl = tuple(slice(offs[i], offs[i] + s[i] * (out_sp[i] - 1) + 1, s[i])
                   for i in range(n))
        vals.append(padded[(slice(None), slice(None)) + sl])
        idxs.append(pos[sl])
    arg = torch.stack(vals, -1).argmax(-1, keepdim=True)
    pidx = torch.stack(idxs, -1).expand(arg.shape[:-1] + (len(idxs),))
    return torch.gather(pidx, -1, arg)[..., 0].to(torch.int32)


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, n,
                data_format):
    """Pooled values scattered back to their argmax positions (zeros
    elsewhere): the inverse of max pooling with ``return_mask``."""
    if isinstance(padding, str):
        raise ValueError(
            f"max_unpool{n}d does not accept string padding {padding!r}; "
            "pass the numeric padding used by the matching max_pool")
    k = _norm_tuple(kernel_size, n)
    s = _norm_tuple(stride if stride is not None else kernel_size, n)
    pad = _norm_padding(padding, n)
    if output_size is not None:
        out_sp = tuple(int(o) for o in output_size[-n:])
    else:
        out_sp = tuple((x.shape[2 + i] - 1) * s[i] - sum(pad[i]) + k[i]
                       for i in range(n))
    N, C = x.shape[:2]
    flat = torch.zeros((N, C, math.prod(out_sp)), dtype=x.dtype,
                       device=x.device)
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(),
                        x.reshape(N, C, -1))
    return flat.reshape((N, C) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       1, data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       2, data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       3, data_format)


def _lp_pool(x, norm_type, kernel_size, stride, padding, n, data_format,
             ceil_mode=False):
    """``(sum |x|^p)^(1/p)`` over windows (zero padding); ``p = inf`` is
    max pooling."""
    p = float(norm_type)
    if p == float("inf"):
        return _pool(x, kernel_size, stride, padding, n, data_format, "max",
                     ceil_mode)
    k = _norm_tuple(kernel_size, n)
    s = _norm_tuple(stride if stride is not None else kernel_size, n)
    pad = _norm_padding(padding, n)
    x, = amp.cast(f"lp_pool{n}d", x)
    v = to_channels_first(x, data_format)
    pairs = _resolve_pad(pad, tuple(v.shape[2:]), k, s, ceil_mode)
    summed = _AVG[n](pad_pairs(v.abs() ** p, pairs), k, s) * math.prod(k)
    return from_channels_first(summed ** (1.0 / p), data_format)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 1,
                    data_format, ceil_mode)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 2,
                    data_format, ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format, "avg",
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    if divisor_override:
        k = _norm_tuple(kernel_size, 2)
        out = _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                    ceil_mode, False)
        return out * ((k[0] * k[1]) / float(divisor_override))
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): torch.nn.functional.adaptive_avg_pool1d,
             ("avg", 2): torch.nn.functional.adaptive_avg_pool2d,
             ("avg", 3): torch.nn.functional.adaptive_avg_pool3d,
             ("max", 1): torch.nn.functional.adaptive_max_pool1d,
             ("max", 2): torch.nn.functional.adaptive_max_pool2d,
             ("max", 3): torch.nn.functional.adaptive_max_pool3d}


def _adaptive(x, output_size, n, data_format, kind):
    """PyTorch's adaptive pooling, whose bins are the reference's; an
    output size of None keeps that dim."""
    osz = _norm_tuple(output_size, n) if output_size is not None \
        else (None,) * n
    x, = amp.cast(f"adaptive_{kind}_pool{n}d", x)
    v = to_channels_first(x, data_format)
    osz = tuple(v.shape[2 + i] if o is None else o for i, o in enumerate(osz))
    return from_channels_first(_ADAPTIVE[kind, n](v, osz), data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "NCL", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "NCDHW", "max")


def _fractional_boundaries(in_size, out_size, u):
    """Region boundaries of Graham's pseudo-random sequence: ``b_i =
    ceil(alpha (i + u))``, ``b_0 = 0``, ``b_out = in``."""
    alpha = in_size / out_size
    b = np.ceil(alpha * (np.arange(out_size) + u)).astype(np.int64)
    b = np.concatenate([[0], np.minimum(b[:-1], in_size - 1), [in_size]])
    return np.maximum.accumulate(b)


def _fractional_pool_axis(v, axis, in_size, out_size, u):
    """Max over each region of one axis (a region may be empty when the
    sequence degenerates; then, as the reference's segment max, -inf)."""
    b = _fractional_boundaries(in_size, out_size, u)
    seg = np.minimum(np.searchsorted(b[1:], np.arange(in_size), side="right"),
                     out_size - 1)
    shape = list(v.shape)
    shape[axis] = out_size
    out = torch.full(shape, float("-inf"), dtype=v.dtype, device=v.device)
    idx = torch.as_tensor(seg, device=v.device).reshape(
        [-1 if i == axis else 1 for i in range(v.ndim)]).expand(v.shape)
    return out.scatter_reduce(axis, idx, v, "amax", include_self=True)


def draw_fractional_u(generator=None):
    """A region offset in the open interval (0, 1), from ``generator``."""
    u = float(torch.rand((), generator=generator))
    return min(max(u, 1e-6), 1.0 - 1e-6)


def _fractional_max_pool(x, output_size, n, random_u, generator):
    if random_u is None:
        random_u = draw_fractional_u(generator)
    if not 0 < float(random_u) < 1:
        raise ValueError(f"random_u must be in (0, 1), got {random_u}")
    out_sp = _norm_tuple(output_size, n)
    for i in range(n):
        if out_sp[i] > x.shape[2 + i]:
            raise ValueError(
                f"fractional_max_pool{n}d: output_size {out_sp} exceeds "
                f"input spatial shape {tuple(x.shape[2:])} on dim {i}")
    x, = amp.cast(f"fractional_max_pool{n}d", x)
    out = x
    for i in range(n):
        out = _fractional_pool_axis(out, 2 + i, x.shape[2 + i], out_sp[i],
                                    float(random_u))
    return out


def _fractional_checks(n, kernel_size, return_mask):
    if return_mask:
        raise NotImplementedError(
            f"fractional_max_pool{n}d(return_mask=True): indices of "
            "fractional regions are not exposed")
    if kernel_size is not None:
        raise NotImplementedError(
            f"fractional_max_pool{n}d(kernel_size=...): overlapping "
            "fractional pooling is not implemented; omit kernel_size for "
            "the disjoint mode")


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None, generator=None):
    """Max over the disjoint pseudo-random regions (NCHW); deterministic
    given ``random_u``.  The overlapping mode (``kernel_size``) and
    ``return_mask`` raise, as in the reference."""
    _fractional_checks(2, kernel_size, return_mask)
    return _fractional_max_pool(x, output_size, 2, random_u, generator)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None, generator=None):
    """:func:`fractional_max_pool2d` over NCDHW."""
    _fractional_checks(3, kernel_size, return_mask)
    return _fractional_max_pool(x, output_size, 3, random_u, generator)
