"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Each initializer is a callable ``(shape, dtype=None, generator=None,
device=None) -> torch.Tensor`` drawing from ``generator`` (torch's default
generator of ``device`` when None, which ``paddle_tpu_torch.seed`` seeds).
``shape`` is in paddle's layout: a ``Linear`` weight is ``[in, out]``, so
``fan_in`` is ``shape[0]``; a conv weight ``[out, in, *kernel]`` counts
its receptive field, as the reference does.  The draws are torch's, not
JAX's: the fans, gains and moments are the reference's, the bits are not.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _dtype(dtype):
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _fans(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = 1
    for s in shape[2:]:
        rf *= s
    return shape[1] * rf, shape[0] * rf


def _draw_device(generator, device):
    return generator.device if generator is not None else torch.device(
        device or "cpu")


class Initializer:
    def __call__(self, shape, dtype=None, generator=None, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, generator=None, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, generator=None, device=None):
        z = torch.randn(tuple(shape), generator=generator,
                        device=_draw_device(generator, device))
        return (self.mean + self.std * z).to(_dtype(dtype)).to(
            device or z.device)


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` a standard normal truncated to
    ``[a, b]`` (in standard units, as ``jax.random.truncated_normal``),
    drawn by the inverse CDF."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=None, generator=None, device=None):
        lo = 0.5 * (1.0 + math.erf(self.a / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(self.b / math.sqrt(2.0)))
        u = torch.rand(tuple(shape), generator=generator,
                       device=_draw_device(generator, device),
                       dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
        z = z.clamp(self.a, self.b)
        return (self.mean + self.std * z).to(_dtype(dtype)).to(
            device or z.device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, generator=None, device=None):
        u = torch.rand(tuple(shape), generator=generator,
                       device=_draw_device(generator, device))
        return (self.low + (self.high - self.low) * u).to(
            _dtype(dtype)).to(device or u.device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, generator=None, device=None):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, generator, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, generator=None, device=None):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, generator, device)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=None, generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        gain = _kaiming_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, generator,
                                                 device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=None, generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        gain = _kaiming_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, generator, device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, generator=None, device=None):
        v = self.value
        v = v.detach() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
        return v.to(dtype=_dtype(dtype), device=device).reshape(tuple(shape))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, generator=None, device=None):
        out = np.zeros(shape, dtype="float32")
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                out[(g * (oc // self.groups) + i, i) + tuple(centers)] = 1.0
        return torch.from_numpy(out).to(dtype=_dtype(dtype), device=device)


class Orthogonal(Initializer):
    """``gain`` times a (semi-)orthogonal matrix over the last axis, as
    ``jax.nn.initializers.orthogonal()``: the Q of a normal matrix's QR
    with R's diagonal signs folded in."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, generator=None, device=None):
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                        generator=generator,
                        device=_draw_device(generator, device))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(
            dtype=_dtype(dtype), device=device or q.device)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


class Bilinear(Initializer):
    """Bilinear-upsample stencil of a 4-D transposed-conv weight
    ``[Cout, Cin, K, K]``, per channel pair."""

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D conv weight")
        co, ci, kh, kw = shape
        f_h, f_w = math.ceil(kh / 2), math.ceil(kw / 2)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og_h = np.arange(kh).reshape(-1, 1)
        og_w = np.arange(kw).reshape(1, -1)
        filt = ((1 - np.abs(og_h / f_h - c_h))
                * (1 - np.abs(og_w / f_w - c_w))).astype("float32")
        w = np.ascontiguousarray(np.broadcast_to(filt, shape))
        return torch.from_numpy(w).to(dtype=_dtype(dtype), device=device)


_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers of the ``Linear`` layers made after this call
    (None restores Xavier-uniform weights and zero biases)."""
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


def _global_default(is_bias):
    return _GLOBAL_INIT["bias" if is_bias else "weight"]
