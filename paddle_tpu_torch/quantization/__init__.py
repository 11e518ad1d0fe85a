"""paddle_tpu_torch.quantization (counterpart of ``paddle_tpu/quantization``).

- Quantization-aware training and post-training quantization, SIMULATED
  (fake-quant) numerics as in the TPU package: values round-trip through
  the int grid with a straight-through estimator (:class:`_FakeQuant`, a
  ``torch.autograd.Function``), so QAT trains through the rounding, and
  PTQ calibrates scales by observing absmax during forwards.
  :class:`QAT` / :class:`PTQ` wrap every quantable layer (the port's and
  ``torch.nn``'s ``Linear``; the port has no Conv layers yet) in a
  :class:`_QuantedWrapper` with ``inner``, ``act_quanter`` and
  ``weight_quanter``, named as in the TPU package, so
  :func:`extract_scales` gives the same keys.
- :func:`convert_to_int8` — the deploy conversion: every wrapped Linear
  becomes an :class:`Int8Linear` with the trained weight-quanter scale and
  a STATIC activation scale.
- The public deploy-grid primitives :func:`absmax_scale`,
  :func:`quantize`, :func:`quantize_absmax` and :func:`dequantize`
  (``ops/quant.py``), shared by :class:`Int8Linear`, the serving engine's
  quantized KV page pools and the calibration harness, so the scales of
  the weight and cache paths cannot drift apart.
- :class:`Int8Linear` — a Linear whose weight is stored as int8.

Dtypes follow the TPU package's promotion, not torch's 0-d rule: a
float32 scale promotes a bf16 input to float32 (``x / scale`` and the STE
mask run in the promoted dtype).  Every division is by a tensor, and the
moving-average constants are cast to the operand's dtype first, so the
card computes the CPU's bytes.  The float32 scale buffers stay float32
when a module is cast to another dtype.
"""

from __future__ import annotations

import torch

from ..ops.quant import (absmax_scale, dequantize, over_qmax,  # noqa: F401
                         quantize, quantize_absmax, qmax_for)


class _F32Buffers(torch.nn.Module):
    """A module whose buffers named in ``_f32_buffers`` keep float32 when
    the module is cast (``.to(torch.bfloat16)``, ``.half()``): they move to
    the new device, never to the new dtype."""

    _f32_buffers = ()

    def _apply(self, fn, recurse=True):
        keep = {n: self._buffers[n] for n in self._f32_buffers
                if self._buffers.get(n) is not None}
        super()._apply(fn, recurse)
        for n, t in keep.items():
            if self._buffers[n].dtype != t.dtype:
                self._buffers[n] = t.to(self._buffers[n].device)
        return self


class _FakeQuant(torch.autograd.Function):
    """``clip(round(x / scale), qmin, qmax) * scale``; backward the
    straight-through estimator ``g * (|x| <= scale * qmax)``, no gradient
    to ``scale``.  Runs in the promoted dtype of x and scale."""

    @staticmethod
    def forward(ctx, x, scale, qmin, qmax):
        dt = torch.promote_types(x.dtype, scale.dtype)
        xs, s = x.to(dt), scale.to(dt)
        ctx.save_for_backward(xs, s)
        ctx.qmax = qmax
        return torch.clamp(torch.round(xs / s), qmin, qmax) * s

    @staticmethod
    def backward(ctx, g):
        xs, s = ctx.saved_tensors
        inside = (xs.abs() <= s * torch.full_like(s, ctx.qmax)).to(g.dtype)
        return g * inside, None, None, None


def _fake_quant(x, scale, qmin, qmax):
    return _FakeQuant.apply(x, scale, qmin, qmax)


def quant_absmax(x, bits=8):
    """Per-tensor absmax fake-quant (the reference's default quanter)."""
    qmax = qmax_for(bits)
    scale = over_qmax(torch.clamp(x.detach().abs().amax(), min=1e-8), bits)
    return _fake_quant(x, scale, -qmax, qmax)


class FakeQuanterWithAbsMaxObserver(_F32Buffers):
    """QAT quanter: fake-quant with a moving-average absmax scale buffer
    (reference: quanter of the same name).

    As in the TPU package, the running scale restarts from the current
    absmax whenever it is <= 1 (the buffer starts at 1.0, so this is the
    first call's rule, but it holds on every call while the scale stays
    <= 1), and in eval mode the updated scale quantizes the input but is
    not stored."""

    _f32_buffers = ("scale",)

    def __init__(self, moving_rate=0.9, bit_length=8, dtype="float32",
                 name=None):
        super().__init__()
        self.moving_rate = moving_rate
        self.bits = bit_length
        # ctor args recorded so QAT / PTQ clone per-layer quanters with them
        self._kwargs = {"moving_rate": moving_rate, "bit_length": bit_length,
                        "dtype": dtype}
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))

    def forward(self, x):
        qmax = qmax_for(self.bits)
        rate = self.moving_rate
        s = self.scale
        absmax = torch.clamp(x.detach().abs().amax(), min=1e-8)
        new_s = torch.where(
            s <= 1.0 + 1e-9, absmax,
            torch.full_like(s, rate) * s
            + torch.full_like(absmax, 1 - rate) * absmax)
        out = _fake_quant(x, over_qmax(new_s, self.bits), -qmax, qmax)
        if self.training:
            with torch.no_grad():
                s.copy_(new_s)
        return out


FakeQuanterWithAbsMaxObserverLayer = FakeQuanterWithAbsMaxObserver


class AbsmaxObserver(_F32Buffers):
    """PTQ observer: records the running absmax, passes values through."""

    _f32_buffers = ("absmax",)

    def __init__(self, quant_bits=8):
        super().__init__()
        self.bits = quant_bits
        self._kwargs = {"quant_bits": quant_bits}
        self.register_buffer("absmax", torch.zeros((), dtype=torch.float32))

    def forward(self, x):
        with torch.no_grad():
            self.absmax.copy_(torch.maximum(self.absmax,
                                            x.detach().abs().amax()))
        return x

    def scale(self):
        return float(self.absmax) / qmax_for(self.bits)


class QuantConfig:
    """reference: paddle.quantization.QuantConfig — maps layer types /
    instances to (activation, weight) quanter prototypes."""

    def __init__(self, activation=None, weight=None):
        self.default_activation = activation
        self.default_weight = weight
        self._type_configs = {}
        self._layer_configs = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) else [layer_type]
        for t in types:
            self._type_configs[t] = (activation, weight)

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._layer_configs[id(l)] = (activation, weight)

    def _for(self, layer):
        if id(layer) in self._layer_configs:
            return self._layer_configs[id(layer)]
        for t, cfg in self._type_configs.items():
            if isinstance(layer, t):
                return cfg
        return self.default_activation, self.default_weight


class _QuantedWrapper(torch.nn.Module):
    """Wraps a Linear: fake-quants its input and its weight.  The weight
    is never written: the inner Linear is called with the fake-quantized
    weight bound in its place (``torch.func.functional_call``), so it keeps
    its own AMP cast and the STE gradient lands on ``inner.weight``."""

    def __init__(self, inner, act_quanter, weight_quanter):
        super().__init__()
        self.inner = inner
        self.act_quanter = act_quanter
        self.weight_quanter = weight_quanter

    def forward(self, x):
        if self.act_quanter is not None:
            x = self.act_quanter(x)
        if self.weight_quanter is None:
            return self.inner(x)
        wq = self.weight_quanter(self.inner.weight)
        return torch.func.functional_call(self.inner, {"weight": wq}, (x,))


def _quantable(layer):
    return isinstance(layer, torch.nn.Linear)


def _clone_quanter(proto, default_cls):
    """Fresh quanter per wrapped layer, built from the prototype's recorded
    ctor kwargs (so e.g. ``bit_length=4`` is kept)."""
    if proto is None:
        return default_cls()
    return proto.__class__(**getattr(proto, "_kwargs", {}))


def _wrap_model(model, config, default_cls):
    """Wrap quantable layers, resolving quanters per layer through
    ``config._for`` (type and layer overrides)."""
    for name, sub in list(model.named_modules())[1:]:
        parent, attr = _resolve_parent(model, name)
        if _quantable(sub) and not isinstance(parent, _QuantedWrapper):
            act_proto, w_proto = config._for(sub)
            wrapper = _QuantedWrapper(sub,
                                      _clone_quanter(act_proto, default_cls),
                                      _clone_quanter(w_proto, default_cls))
            setattr(parent, attr, wrapper)
    return model


def _resolve_parent(model, name):
    """``(parent module, attribute name)`` of the dotted sublayer ``name``."""
    parent = model
    parts = name.split(".")
    for p in parts[:-1]:
        parent = getattr(parent, p)
    return parent, parts[-1]


class QAT:
    """Quantization-aware training (reference: paddle.quantization.QAT):
    ``quantize(model)`` wraps quantable layers with fake-quanters; train as
    usual (STE gradients flow); scales live in buffers."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model, inplace=True):
        return _wrap_model(model, self.config, FakeQuanterWithAbsMaxObserver)


class PTQ:
    """Post-training quantization: ``quantize`` inserts observers, run
    calibration batches, then ``convert`` freezes the observed scales into
    fake-quant layers."""

    def __init__(self, config: QuantConfig = None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        return _wrap_model(model, self.config, AbsmaxObserver)

    def convert(self, model, inplace=True):
        for _, sub in model.named_modules():
            if isinstance(sub, _QuantedWrapper):
                for attr in ("act_quanter", "weight_quanter"):
                    obs = getattr(sub, attr)
                    if isinstance(obs, AbsmaxObserver):
                        setattr(sub, attr, _FrozenFakeQuant(obs.scale(),
                                                            obs.bits))
        return model


class _FrozenFakeQuant(_F32Buffers):
    """Fake-quant at a fixed scale (PTQ's converted observer).  The scale
    is an attribute, as in the TPU package; its float32 tensor is a
    non-persistent buffer that follows the module's device."""

    _f32_buffers = ("_scale_t",)

    def __init__(self, scale, bits=8):
        super().__init__()
        self._scale = max(scale, 1e-8)
        self._qmax = qmax_for(bits)
        self.register_buffer("_scale_t", torch.tensor(self._scale,
                                                      dtype=torch.float32),
                             persistent=False)

    def forward(self, x):
        return _fake_quant(x, self._scale_t, -self._qmax, self._qmax)


def extract_scales(model):
    """``{layer_name: scale}`` for every quanter of a quantized model — the
    deploy artifact (reference: the scales written into the inference
    program)."""
    out = {}
    for name, sub in model.named_modules():
        if isinstance(sub, FakeQuanterWithAbsMaxObserver):
            out[name] = float(sub.scale) / qmax_for(sub.bits)
        elif isinstance(sub, _FrozenFakeQuant):
            out[name] = sub._scale
        elif isinstance(sub, AbsmaxObserver):
            out[name] = sub.scale()
    return out


def convert_to_int8(model, scales=None):
    """Replace every quantized Linear with an :class:`Int8Linear` consuming
    the :func:`extract_scales` dict — the deploy conversion.

    Call on a model whose Linears are ``_QuantedWrapper``s (after QAT
    training or PTQ calibrate + convert); ``scales`` defaults to
    ``extract_scales(model)``.  Weights requantize from their CURRENT
    values with each wrapper's weight-quanter scale; activations use the
    observed act-quanter scale (static quantization).  A wrapper without a
    usable weight scale (missing, or an observer that never saw data and
    reports its epsilon floor) keeps its fake-quant numerics.
    """
    if scales is None:
        scales = extract_scales(model)
    for name, sub in list(model.named_modules())[1:]:
        if not isinstance(sub, _QuantedWrapper) \
                or not isinstance(sub.inner, torch.nn.Linear):
            continue
        w_scale = scales.get(f"{name}.weight_quanter")
        act_scale = scales.get(f"{name}.act_quanter")
        if w_scale is None or w_scale <= 1e-7:
            continue
        parent, attr = _resolve_parent(model, name)
        bits = getattr(sub.weight_quanter, "bits", 8)
        setattr(parent, attr,
                Int8Linear(sub.inner, w_scale, act_scale, bits=bits))
    return model


# torch._int_mm on the card takes more than 16 rows (and K, N multiples of
# 8); smaller inputs get zero rows (zero outputs, sliced off)
_INT_MM_MIN_ROWS = 17


class Int8Linear(_F32Buffers):
    """Deploy-time int8 linear: the weight is stored AS int8
    (``weight_int8``, torch's ``[out, in]`` layout; the state-dict converter
    carries it in paddle's ``[in, out]``), the product runs int8 x int8 ->
    int32 (``torch._int_mm``, cuBLAS on the card), and is dequantized by the
    product of the two per-tensor scales, in the TPU package's order:
    ``y.float() * (s_a * w_scale)``, then ``+ bias`` in float32, then cast
    to the input's dtype.

    ``act_scale`` (e.g. from :func:`convert_to_int8`) quantizes the
    activations with that static scale; ``act_scale=None`` quantizes them
    dynamically with ONE absmax scale over the whole input — so every row
    of a batch moves the scale of every other row, as in the TPU package.
    """

    _f32_buffers = ("_w_scale", "_act_scale")

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
