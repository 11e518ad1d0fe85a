"""Int8 weight path for the serving engine (counterpart of
``paddle_tpu/serving/quant/weights.py``).

``quantize_model_weights(model)`` converts every ``nn.Linear`` of the
model to a :class:`paddle_tpu_torch.quantization.Int8Linear` IN PLACE:
weights live on the device as int8 buffers, the products run int8 x int8
-> int32, and the shared grid (``quantization.quantize`` /
``quantize_absmax``) keeps the scales in step with the KV-pool path.
``ServingEngine(weight_dtype="int8")`` calls it before building its
adapter; the conversion is idempotent.  (GPT's LM head is tied to the
embedding, so only the decoder Linears convert.)

Scales come from, in priority order:

1. an explicit ``scales`` dict ``{sublayer_name: w_scale}`` (the
   ``.weight_quanter`` suffix is accepted too), e.g. from the calibration
   harness (``serving.quant.calibrate``);
2. per-layer absmax over the current weight values.

Activations quantize dynamically per call (Int8Linear's ``act_scale=None``
path) unless ``scales`` carries ``<name>.act_quanter`` entries.

NOTE: conversion mutates the model the caller passed in.  To compare
against the full-precision model, run the reference BEFORE converting
(what ``serving.quant.calibrate`` does).
"""

from __future__ import annotations

import torch


def _resolve_parent(model, name):
    parent = model
    parts = name.split(".")
    for p in parts[:-1]:
        parent = getattr(parent, p)
    return parent, parts[-1]


def _linears(model):
    """``(name, module)`` for every not-yet-converted Linear."""
    return [(n, m) for n, m in model.named_modules()
            if n and isinstance(m, torch.nn.Linear)]


def quantize_model_weights(model, scales=None, bits=8):
    """Convert the model's ``nn.Linear`` sublayers to int8 (see module
    docstring).  Returns the number converted by this call (0 when the
    model was already converted)."""
    from ...quantization import Int8Linear, absmax_scale

    scales = scales or {}
    converted = 0
    for name, sub in _linears(model):
        w_scale = scales.get(name, scales.get(f"{name}.weight_quanter"))
        if w_scale is None:
            w_scale = float(absmax_scale(sub.weight.detach(), bits=bits))
        if w_scale <= 1e-7:
            # degenerate scale (an un-calibrated observer's floor):
            # converting would saturate every weight — keep full precision
            continue
        act_scale = scales.get(f"{name}.act_quanter")
        parent, attr = _resolve_parent(model, name)
        setattr(parent, attr, Int8Linear(sub, w_scale, act_scale, bits=bits))
        converted += 1
    return converted


@torch.no_grad()
def weight_quant_error(model, bits=8):
    """Per-Linear relative round-trip error ``||deq(q(w)) - w|| / ||w||``
    for every not-yet-converted ``nn.Linear``."""
    from ...quantization import dequantize, quantize_absmax

    out = {}
    for name, sub in _linears(model):
        w = sub.weight.detach().float()
        q, scale = quantize_absmax(w, bits=bits)
        err = torch.linalg.norm(dequantize(q, scale) - w) \
            / torch.clamp(torch.linalg.norm(w), min=1e-12)
        out[name] = float(err)
    return out
