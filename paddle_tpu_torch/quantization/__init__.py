"""paddle_tpu_torch.quantization (counterpart of ``paddle_tpu/quantization``;
its int8 deploy layer and the shared grid).

- The public deploy-grid primitives :func:`absmax_scale`,
  :func:`quantize`, :func:`quantize_absmax` and :func:`dequantize`
  (``ops/quant.py``), shared by :class:`Int8Linear`, the serving engine's
  quantized KV page pools and the calibration harness, so the scales of
  the weight and cache paths cannot drift apart.
- :class:`Int8Linear` — a Linear whose weight is stored as int8.

QAT, PTQ, the fake-quant observers and ``convert_to_int8`` are not ported
yet.
"""

from __future__ import annotations

import torch

from ..ops.quant import (absmax_scale, dequantize, quantize,  # noqa: F401
                         quantize_absmax, qmax_for)

# torch._int_mm on the card takes more than 16 rows (and K, N multiples of
# 8); smaller inputs get zero rows (zero outputs, sliced off)
_INT_MM_MIN_ROWS = 17


class Int8Linear(torch.nn.Module):
    """Deploy-time int8 linear: the weight is stored AS int8
    (``weight_int8``, torch's ``[out, in]`` layout; the state-dict converter
    carries it in paddle's ``[in, out]``), the product runs int8 x int8 ->
    int32 (``torch._int_mm``, cuBLAS on the card), and is dequantized by the
    product of the two per-tensor scales, in the TPU package's order:
    ``y.float() * (s_a * w_scale)``, then ``+ bias`` in float32, then cast
    to the input's dtype.

    ``act_scale=None`` quantizes the activations dynamically with ONE
    absmax scale over the whole input — so every row of a batch moves the
    scale of every other row, as in the TPU package.
    """

    def __init__(self, linear, w_scale, act_scale=None, bits=8):
        super().__init__()
        self._bits = int(bits)
        self._qmax = qmax_for(bits)
        self.w_scale = float(max(w_scale, 1e-8))
        self.act_scale = float(act_scale) if act_scale else None
        w = linear.weight.detach()
        # the scales as float32 tensors that follow the module's device;
        # not state (the TPU package keeps them as plain attributes)
        self.register_buffer("_w_scale", torch.tensor(
            self.w_scale, dtype=torch.float32, device=w.device),
            persistent=False)
        self.register_buffer("_act_scale", None if self.act_scale is None
                             else torch.tensor(self.act_scale,
                                               dtype=torch.float32,
                                               device=w.device),
                             persistent=False)
        self.register_buffer("weight_int8",
                             quantize(w, self._w_scale, bits=bits))
        self.bias = getattr(linear, "bias", None)

    def forward(self, x):
        if self._act_scale is not None:
            s_a = self._act_scale
            xq = quantize(x, s_a, bits=self._bits)
        else:
            xq, s_a = quantize_absmax(x, bits=self._bits)
        y = _int8_matmul(xq.reshape(-1, xq.shape[-1]), self.weight_int8.t())
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        out = y.float() * (s_a * self._w_scale)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


def _int8_matmul(a, b):
    """``a [M, K] int8 @ b [K, N] int8 -> int32``, exact.  Rows are padded
    with zeros up to what ``torch._int_mm`` takes on the card (the same
    padding runs on the CPU, where the call has no such limit)."""
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - m, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b)[:m]
