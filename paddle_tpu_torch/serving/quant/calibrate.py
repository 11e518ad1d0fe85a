"""Calibration / accuracy harness for quantized serving (counterpart of
``paddle_tpu/serving/quant/calibrate.py``).

``calibrate(model, prompts)`` answers what the int8 path costs in accuracy
and buys in device memory:

1. runs the calibration batch through the full-precision engine first
   (greedy), recording every request's token stream — the reference;
2. measures per-layer K/V round-trip error on the calibration prompts and
   per-layer weight round-trip error;
3. picks weight scales (``method="absmax"`` or outlier-robust
   ``"percentile"``) and, with ``weight_dtype="int8"``, converts the model
   via :func:`~.weights.quantize_model_weights`;
4. runs the same prompts through ``ServingEngine(kv_dtype="int8")`` and
   reports top-1 agreement with the reference streams;
5. reports bytes per KV token for both layouts and their ratio.

The reference runs BEFORE any conversion, so one model object suffices.
The engines run on the card unless ``engine_kwargs`` says
``{"device": "cpu"}``.
"""

from __future__ import annotations

import numpy as np
import torch


def choose_scale(x, axis=None, method="absmax", pct=99.9, bits=8, eps=1e-8):
    """Scale for a symmetric int grid: ``absmax`` covers every value (no
    clipping, coarser grid); ``percentile`` clips the top ``100 - pct``
    percent of magnitudes for a finer grid on the bulk.  Keepdims
    semantics as :func:`paddle_tpu_torch.quantization.absmax_scale`."""
    from ...ops.quant import over_qmax
    from ...quantization import absmax_scale

    if method == "absmax":
        return absmax_scale(x, axis=axis, bits=bits, eps=eps)
    if method != "percentile":
        raise ValueError(f"method must be 'absmax' or 'percentile', "
                         f"got {method!r}")
    a = x.float().abs()
    m = torch.quantile(a, pct / 100.0) if axis is None \
        else torch.quantile(a, pct / 100.0, dim=axis, keepdim=True)
    return over_qmax(torch.clamp(m, min=eps), bits)


@torch.no_grad()
def kv_quant_error(model, prompts, bits=8):
    """Per-layer K/V round-trip error on the calibration prompts.

    Runs each prompt through the decoder with no cache and takes every
    layer's K and V from its qkv projection (the tensors the paged writes
    would quantize), rounds them onto the pool grid (per-position-per-head
    absmax, ``ops.paged_attention.quantize_kv``'s layout) and returns the
    relative L2 error per layer."""
    from ...quantization import dequantize, quantize_absmax

    gpt = model.gpt
    L = len(gpt.layers)
    sq_err = np.zeros(L)
    sq_ref = np.zeros(L)
    captured = {}

    def hook(i, hd):
        def fn(_module, _inp, out):
            B, S = out.shape[:2]
            qkv = out.reshape(B, S, -1, 3, hd)
            captured[i] = (qkv[:, :, :, 1], qkv[:, :, :, 2])
        return fn

    handles = [blk.qkv.register_forward_hook(hook(i, blk.head_dim))
               for i, blk in enumerate(gpt.layers)]
    device = gpt.word_embeddings.weight.device
    try:
        for p in prompts:
            ids = torch.as_tensor(np.asarray(p, np.int64)[None, :],
                                  device=device)
            gpt(ids)
            for i in range(L):
                for t in captured[i]:
                    t = t.float()
                    q, scale = quantize_absmax(t, axis=-1, bits=bits)
                    d = dequantize(q, scale) - t
                    sq_err[i] += float((d * d).sum())
                    sq_ref[i] += float((t * t).sum())
    finally:
        for h in handles:
            h.remove()
    return [float(np.sqrt(e / max(r, 1e-12))) for e, r in zip(sq_err, sq_ref)]


def _run_engine(model, prompts, max_new_tokens, kv_dtype, page_size,
                num_slots, timeout, engine_kwargs):
    from ..engine import ServingEngine

    max_len = max(len(p) for p in prompts) + max_new_tokens
    eng = ServingEngine(model, num_slots=num_slots, page_size=page_size,
                        max_model_len=max_len, kv_dtype=kv_dtype,
                        **(engine_kwargs or {}))
    with eng:
        handles = [eng.submit(p, max_new_tokens=max_new_tokens)
                   for p in prompts]
        ids = [h.result(timeout=timeout) for h in handles]
        stats = eng.stats()
    return ids, stats


def top1_agreement(ref_ids, got_ids):
    """Fraction of generated positions whose token matches the reference
    stream, over all requests (compared up to the shorter stream)."""
    match = total = 0
    for r, g in zip(ref_ids, got_ids):
        n = min(len(r), len(g))
        total += max(len(r), len(g))
        match += sum(1 for i in range(n) if r[i] == g[i])
    return match / total if total else 1.0


def calibrate(model, prompts, max_new_tokens=32, weight_dtype=None,
              scale_method="absmax", pct=99.9, bits=8, page_size=16,
              num_slots=4, engine_kwargs=None, timeout=600):
    """Run the calibration workflow (module docstring) and return the
    report dict.  ``weight_dtype="int8"`` also converts the model's
    Linears in place (after the reference is captured)."""
    from ..adapter import GPTAdapter
    from .adapter import QuantizedGPTAdapter
    from .weights import _linears, quantize_model_weights, weight_quant_error

    prompts = [[int(t) for t in np.asarray(p).reshape(-1)] for p in prompts]

    # 1. full-precision reference FIRST (weight conversion is in place)
    ref_ids, ref_stats = _run_engine(
        model, prompts, max_new_tokens, None, page_size, num_slots,
        timeout, engine_kwargs)

    # 2. per-layer round-trip errors on the calibration batch
    per_layer_kv = kv_quant_error(model, prompts, bits=bits)
    per_layer_w = weight_quant_error(model, bits=bits)

    # 3. weight scales (+ optional in-place conversion)
    converted = 0
    scales = None
    if weight_dtype is not None and str(weight_dtype).lower() == "int8":
        scales = {name: float(choose_scale(sub.weight.detach(),
                                           method=scale_method, pct=pct,
                                           bits=bits))
                  for name, sub in _linears(model)}
        converted = quantize_model_weights(model, scales=scales, bits=bits)

    # 4. the int8 engine on the same prompts
    q_ids, q_stats = _run_engine(
        model, prompts, max_new_tokens, "int8", page_size, num_slots,
        timeout, engine_kwargs)
    agreement = top1_agreement(ref_ids, q_ids)

    # 5. occupancy: bytes per KV token for both layouts
    base = GPTAdapter(model, page_size)
    quant = QuantizedGPTAdapter(model, page_size)
    bpt = {"reference": base.page_bytes() / page_size,
           "int8": quant.page_bytes() / page_size}
    return {
        "requests": len(prompts),
        "max_new_tokens": max_new_tokens,
        "top1_agreement": agreement,
        "per_layer_kv_error": per_layer_kv,
        "per_layer_weight_error": per_layer_w,
        "weight_scales": scales,
        "weights_converted": converted,
        "kv_bytes_per_token": bpt,
        "occupancy_ratio": bpt["reference"] / bpt["int8"],
        "reference_stats": ref_stats,
        "quantized_stats": q_stats,
        "reference_ids": ref_ids,
        "quantized_ids": q_ids,
    }
