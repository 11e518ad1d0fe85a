"""``paddle.summary`` and ``paddle.flops`` (counterpart of
``paddle_tpu/hapi/model_summary.py``).

:func:`summary` runs the network once in eval mode on zero inputs with a
forward hook on every sub-module and prints the reference's table (name,
type, first output shape, the module's own parameter count) and totals.
:func:`flops` counts one forward at ``input_size`` by the rules of XLA's
cost model, which the reference reads: a matrix product of ``[M, K]`` by
``[K, N]`` is ``2 M N K``; a convolution is 2 x (input channels / groups)
x output channels x batch x, per spatial dim, the count of (kernel tap,
output position) pairs that read the input rather than its padding (so
``2 * output elements * Cin / groups * prod(k)`` when nothing is padded),
and its bias add one per output element; an elementwise add, multiply,
subtract, divide, max or min is one per output element; transcendental
ops (tanh, exp, erf, ...) are not counted.  For a network of ``Linear``
and convolution layers and such activations the total equals the
reference's.  Where XLA rewrites a fused op the two part: a batch norm
(XLA counts about 8 operations per element of the eval-mode norm as it
expands it, the port 2, its scale-and-shift, plus the per-channel
statistics: a 3 -> 8 channel 3x3 conv, batch norm and ReLU on 2 x 3 x 16
x 16 count 244,144 there and 219,552 here, 211,328 both without the
norm), an erf polynomial, pooling (XLA counts window - 1 reductions per
output element, the port none), and a convolution whose uneven padding
the port applies with ``F.pad`` first (its padded taps count here).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _zeros(input_size, dtypes, device):
    sizes = input_size if isinstance(input_size, list) else [input_size]
    sizes = [tuple(s) if isinstance(s, (tuple, list)) else (s,) for s in sizes]
    dts = dtypes if isinstance(dtypes, (list, tuple)) else [dtypes] * len(sizes)
    return [torch.zeros([d if (d and d > 0) else 1 for d in s],
                        dtype=getattr(torch, str(dt or "float32")),
                        device=device)
            for s, dt in zip(sizes, dts)]


def _device(net):
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def summary(net, input_size=None, dtypes=None, input=None):
    if input is None:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        input = _zeros(input_size, dtypes, _device(net))
    else:
        input = input if isinstance(input, (list, tuple)) else [input]

    rows = []
    hooks = []

    def register(layer, name):
        def hook(lay, args, out):
            shapes = [list(o.shape) for o in
                      (out if isinstance(out, (tuple, list)) else (out,))
                      if isinstance(o, torch.Tensor)]
            n_params = sum(int(np.prod(p.shape))
                           for p in lay._parameters.values() if p is not None)
            rows.append((name, type(lay).__name__, shapes, n_params))
        hooks.append(layer.register_forward_hook(hook))

    for name, sub in net.named_modules():
        if name:
            register(sub, name)

    was = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*input)
    finally:
        net.train(was)
        for h in hooks:
            h.remove()

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if p.requires_grad)

    width = 76
    print("-" * width)
    print(f"{'Layer (type)':<38}{'Output Shape':<24}{'Param #':<12}")
    print("=" * width)
    for name, cls, shapes, n in rows:
        shape_s = str(shapes[0]) if shapes else "-"
        print(f"{name + ' (' + cls + ')':<38}{shape_s:<24}{n:<12,}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}


_aten = torch.ops.aten
# one operation per output element
_ELEMENTWISE = {_aten.add.Tensor, _aten.add_.Tensor, _aten.sub.Tensor,
                _aten.mul.Tensor, _aten.mul_.Tensor, _aten.div.Tensor,
                _aten.maximum.default, _aten.minimum.default,
                _aten.relu.default, _aten.relu_.default,
                _aten.clamp_min.default, _aten.where.self}


def _numel(shape):
    return math.prod(shape)


class _FlopCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "overloadpacket", None)
        if packet in (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm):
            a, b = (args[1], args[2]) if packet in (_aten.addmm,
                                                    _aten.baddbmm) \
                else (args[0], args[1])
            k = a.shape[-1]
            self.total += 2 * _numel(out.shape) * k
            if packet in (_aten.addmm, _aten.baddbmm):
                self.total += _numel(out.shape)
        elif packet is _aten.convolution:
            self.total += _conv_flops(args[0], args[1], out, *args[2:9])
        elif func in _ELEMENTWISE and isinstance(out, torch.Tensor):
            self.total += _numel(out.shape)
        return out


def _conv_flops(x, w, out, bias, stride, padding, dilation, transposed,
                output_padding, groups):
    """XLA's convolution count (``HloCostAnalysis``): 2 x features x the
    valid (kernel tap, output position) pairs of each spatial dim, plus
    the bias add.  A transposed convolution is counted as XLA sees it, an
    input-dilated convolution."""
    n = x.ndim - 2
    taps = 1
    for i in range(n):
        L, k, s, d = x.shape[2 + i], w.shape[2 + i], stride[i], dilation[i]
        o = out.shape[2 + i]
        if transposed:     # stride -> input dilation, pads (eff - 1 - p)
            eff = d * (k - 1) + 1
            lo, base, step = eff - 1 - padding[i], s, 1
        else:
            lo, base, step = padding[i], 1, s
        valid = 0
        for kk in range(k):
            for oo in range(o):
                u = oo * step - lo + kk * d
                if u % base == 0 and 0 <= u // base < L:
                    valid += 1
        taps *= valid
    cin_per_group = w.shape[0] // groups if transposed else w.shape[1]
    cout = w.shape[1] * groups if transposed else w.shape[0]
    total = 2 * cin_per_group * cout * x.shape[0] * taps
    return total + (_numel(out.shape) if bias is not None else 0)


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Operations of one eval-mode forward of ``net`` on a float32 zero
    input of ``input_size`` (the module docstring's rules)."""
    x = torch.zeros(tuple(input_size), dtype=torch.float32,
                    device=_device(net))
    counter = _FlopCounter()
    was = net.training
    net.eval()
    try:
        with torch.no_grad(), counter:
            net(x)
    finally:
        net.train(was)
    val = int(counter.total)
    if print_detail:
        print(f"Total Flops: {val}")
    return val
