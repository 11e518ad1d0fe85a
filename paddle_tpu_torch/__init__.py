"""paddle_tpu_torch: the PyTorch / CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module paths (``paddle_tpu_torch/ops/flash_attention.py`` is the
counterpart of ``paddle_tpu/ops/flash_attention.py``, and so on) and
imports neither JAX nor anything of ``paddle_tpu``.  Every Pallas TPU
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``,
built with ``nvcc`` on first use.

Ported so far: the serving slice (GPT causal LM inference, the paged KV
cache and the continuous-batching :class:`~.serving.ServingEngine`), the
training slice (the flash-attention backward, ``cross_entropy``, the
SGD / Momentum / Adam / AdamW optimizers with clipping and LR schedulers,
AMP and :class:`~.jit.TrainStep`), the int8 serving slice (int8 KV
page pools with the dequantizing decode kernel, ``Int8Linear`` and
``serving.quant``) and the custom-op / quantization slice
(:func:`register_op` and :func:`load_op_library` over the fused
bias + GELU kernel, QAT, PTQ and ``quantization.convert_to_int8``),
``generate()`` with speculative decoding and chunked prefill, and the
engine's robustness (restart and requeue, load shedding, the numeric
guard, ``resilience``), the radix prefix cache with its host spill tier,
QoS tiers, and the engine's observability layer (``profiler.metrics``,
span tracing, the flight recorder, ``/metrics`` ``/healthz`` ``/statusz``
telemetry, the memory ledger with the HBM pre-flight, the numerics
stream: ``observability``), the program layer (CUDA graphs, manifests,
the roofline table), multi-tenant and cluster serving
(``serving.multitenant``, ``serving.cluster``, the ``AutoScaler``), and
the breadth of training (all fifteen optimizers, ``incubate``'s
LookAhead / EMA / ModelAverage, ``nn.utils``, ``distributed.fleet
.recompute``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import importlib as _importlib

__version__ = "0.1.0"

# subpackages loaded on first attribute access, as the reference's are
_LAZY = ("amp", "distributed", "framework", "incubate", "jit", "nn",
         "observability", "ops", "optimizer", "profiler", "quantization",
         "resilience", "serving", "text", "utils")


def __getattr__(name):
    if name in _LAZY:
        mod = _importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    # the custom-op plugin surface, as ``paddle_tpu.register_op``
    if name in ("register_op", "load_op_library"):
        from .framework import custom_op

        return getattr(custom_op, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
