"""Shared int8 quantization numerics (counterpart of ``paddle_tpu/ops/quant.py``).

ONE implementation of absmax scale selection, int-grid rounding and
dequantization, used by the serving engine's quantized paged KV pools
(``ops.paged_attention.quantize_kv`` and the ``*_quant`` pool writes),
:class:`paddle_tpu_torch.quantization.Int8Linear` and the calibration
harness (``serving.quant.calibrate``).

The arithmetic follows the TPU package step for step, so the int8 bytes
and float32 scales come out equal: cast to float32 first, ``max(absmax,
eps) / qmax`` in float32, a true division ``x / scale`` in float32,
``torch.round`` (half to even, as ``jnp.round``), clip to ``[-qmax,
qmax]``, then cast to int8.  Every division is by a tensor on the
operand's device: PyTorch's CUDA kernels turn a division by a Python
scalar into a multiply by its reciprocal, which rounds differently.

Convention: symmetric signed grids — ``qmax = 2**(bits-1) - 1`` (127 for
int8, so -128 is never produced), float32 scales, int8 payloads for any
``bits <= 8``.
"""

from __future__ import annotations

import torch


def qmax_for(bits=8):
    """Largest magnitude on the symmetric signed grid for ``bits``."""
    return float(2.0 ** (int(bits) - 1) - 1)


def absmax_scale(x, axis=None, bits=8, eps=1e-8):
    """``max|x| / qmax`` in float32, reduced over ``axis`` with keepdims
    (``axis=None`` reduces everything to a 0-dim tensor); ``eps`` floors
    the absmax so all-zero inputs quantize to zeros."""
    a = x.float().abs()
    m = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return over_qmax(torch.clamp(m, min=eps), bits)


def over_qmax(m, bits=8):
    """``m / qmax`` as a true float32 division on any device."""
    return m / torch.full_like(m, qmax_for(bits))


def quantize(x, scale, bits=8):
    """Round ``x`` onto the symmetric grid of ``scale`` (broadcastable
    against ``x``; a Python float is taken as float32); returns int8."""
    qmax = qmax_for(bits)
    if not torch.is_tensor(scale):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def quantize_absmax(x, axis=None, bits=8, eps=1e-8):
    """``(q int8, scale float32)`` with the scale shaped as
    :func:`absmax_scale` gives it (keepdims)."""
    scale = absmax_scale(x, axis=axis, bits=bits, eps=eps)
    return quantize(x, scale, bits=bits), scale


def dequantize(q, scale, dtype=torch.float32):
    """``q * scale`` in float32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)
