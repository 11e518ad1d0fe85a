"""Fused bias + exact GELU, the custom-op example's kernel (counterpart of
``bias_gelu`` / ``bias_gelu_bwd`` in ``examples/custom_op_and_quant.py``).

- :func:`bias_gelu` — ``gelu_erf(x + b)`` in x's dtype, differentiable
  (:class:`BiasGelu`).  A CPU tensor takes the plain version
  :func:`bias_gelu_ref`; a CUDA tensor launches the hand-written kernel
  ``csrc/bias_gelu.cu`` (K6, the port of the TPU's ``_bias_gelu_kernel``),
  or raises.
- :func:`bias_gelu_bwd` — the TPU package's gradient formula, plain torch
  on every device (it was plain jnp there too, not a Pallas kernel).

Both versions compute in float32 and round once to x's dtype; the TPU
package computes ``x + b`` in the promoted dtype, so a bf16 x with a bf16
bias may differ from it by one bf16 ulp.  ``LAUNCHES`` counts K6 launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the K6 CUDA kernel in this process
LAUNCHES = 0


def bias_gelu_ref(x, b):
    """Plain version of :func:`bias_gelu`, on any device."""
    z = x.float() + b.float()
    return (z * 0.5 * (1.0 + torch.erf(z * 0.70710678))).to(x.dtype)


def bias_gelu_bwd(res, g):
    """``(dx, db)`` of :func:`bias_gelu` at residuals ``res = (x, b)``:
    ``dz = g * (cdf + z * pdf)``, and db the sum of dz over every axis but
    the last."""
    x, b = res
    z = x.float() + b.float()
    cdf = 0.5 * (1.0 + torch.erf(z * 0.70710678))
    pdf = torch.exp(-0.5 * z * z) * 0.3989422804
    dz = g.float() * (cdf + z * pdf)
    db = dz.sum(dim=tuple(range(dz.ndim - 1))) if dz.ndim > 1 else dz
    return dz.to(x.dtype), db.to(b.dtype)


class BiasGelu(torch.autograd.Function):
    """K6 (or its plain version on the CPU) forward, the plain formula of
    :func:`bias_gelu_bwd` backward."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.save_for_backward(x, b)
        return _forward(x, b)

    @staticmethod
    def backward(ctx, g):
        return bias_gelu_bwd(ctx.saved_tensors, g)


def bias_gelu(x, b):
    """``gelu_erf(x + b)`` for x ``[..., N]`` and b ``[N]``, in x's dtype
    (float32, float16 or bfloat16; b of any of them)."""
    return BiasGelu.apply(x, b)


def _forward(x, b):
    _check(x, b)
    if x.device.type == "cpu":
        return bias_gelu_ref(x, b)
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"bias_gelu runs on cuda or cpu tensors, got {x.device}")
    x = x.contiguous()
    b = b.contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().ptt_bias_gelu(x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                   x.numel(), x.shape[-1], _build.dtype_code(x),
                                   _build.dtype_code(b), _build.stream_handle(x))
    _build.check(err, "bias_gelu")
    _build.count_launch(globals(), "LAUNCHES")
    return y


def _check(x, b):
    if not x.is_floating_point() or not b.is_floating_point():
        raise TypeError(f"bias_gelu takes floating x and b, got {x.dtype} "
                        f"and {b.dtype}")
    if x.ndim < 1 or b.ndim != 1 or b.shape[0] != x.shape[-1]:
        raise ValueError(f"bias_gelu needs x [..., N] and b [N], got "
                         f"{tuple(x.shape)} and {tuple(b.shape)}")
    if b.device != x.device:
        raise ValueError(f"b is on {b.device}, x on {x.device}")
    if x.device.type == "cuda":
        _build.dtype_code(x)        # float32 / float16 / bfloat16 only
        _build.dtype_code(b)


def _lib():
    lib = _build.load("bias_gelu")
    fn = lib.ptt_bias_gelu
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, ctypes.c_longlong, I, I, I, P]
        fn.restype = I
    return lib
