"""paddle_tpu_torch.serving.quant — quantized serving (counterpart of
``paddle_tpu/serving/quant``).

- :class:`QuantizedGPTAdapter` — int8 page pools with parallel
  per-(page slot, head) float32 scale pools; quantization fused into the
  pool writes, dequantization into the paged decode kernel (K4).
  ``ServingEngine(kv_dtype="int8")`` builds one.
- :func:`quantize_model_weights` — in-place ``Int8Linear`` conversion of
  the model's Linears on the shared grid; ``ServingEngine(weight_dtype=
  "int8")`` applies it, idempotently.
- :func:`calibrate` — the accuracy harness: the full-precision engine
  first, per-layer KV and weight round-trip errors, scale selection, the
  int8 engine's top-1 agreement and the occupancy win.
"""

from .adapter import QuantizedGPTAdapter  # noqa: F401
from .calibrate import (calibrate, choose_scale, kv_quant_error,  # noqa: F401
                        top1_agreement)
from .weights import quantize_model_weights, weight_quant_error  # noqa: F401

__all__ = [
    "QuantizedGPTAdapter", "quantize_model_weights", "weight_quant_error",
    "calibrate", "choose_scale", "kv_quant_error", "top1_agreement",
]
