"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``).

``batch_norm`` keeps the reference's rules, which are not PyTorch's:

- **running update:** ``running = momentum * running + (1 - momentum) *
  batch`` with ``momentum = 0.9``, over the **biased** batch variance,
  written in place into the buffers under ``no_grad`` in the buffers'
  dtype (PyTorch's momentum is the other weight and its running variance
  is the unbiased one).  In place, so it reaches the module's own buffers
  under ``jit.TrainStep``'s O2 ``functional_call`` (which binds only the
  parameters) and once per micro-batch under ``accumulate_steps``;
- **rounding:** the statistics in float32 (the weight and bias cast to
  float32 first, so a bf16 weight under O2 is rounded to bf16 on the
  way), then ONE scale-and-shift ``x * scale + offset`` in the
  activation's own dtype: a bf16 activation stays bf16 and rounds as the
  reference's does, where a fused float32 normalisation would not;
- gradients flow through the batch statistics; ``use_global_stats``
  overrides ``training``.

``layer_norm`` and ``group_norm`` take float32 statistics and cast the
normalised value back to the input's dtype before the affine, which runs
in that dtype; ``instance_norm`` computes in the input's dtype, as the
reference does.  Under ``amp.auto_cast`` the inputs are cast for the
op's name (none of these is on a list, so O2 casts to the amp dtype).
"""

from __future__ import annotations

import torch

from ... import amp


def _ch_axis(ndim, data_format):
    return 1 if data_format.startswith("NC") else ndim - 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    x, weight, bias = amp.cast("batch_norm", x, weight, bias)
    ch = _ch_axis(x.ndim, data_format)
    reduce = tuple(i for i in range(x.ndim) if i != ch)
    use_batch = training and not use_global_stats
    shape = [1] * x.ndim
    shape[ch] = -1
    if use_batch:
        var, mean = torch.var_mean(x.float(), dim=reduce, correction=0)
    else:
        mean, var = running_mean.float(), running_var.float()
    scale = torch.rsqrt(var + epsilon)
    if weight is not None:
        scale = scale * weight.float()
    offset = -mean * scale
    if bias is not None:
        offset = offset + bias.float()
    out = x * scale.to(x.dtype).reshape(shape) \
        + offset.to(x.dtype).reshape(shape)
    if use_batch and running_mean is not None:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1 - momentum)
                               * mean.to(running_mean.dtype))
            running_var.copy_(momentum * running_var + (1 - momentum)
                              * var.to(running_var.dtype))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    x, weight, bias = amp.cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.ndim - len(tuple(normalized_shape)), x.ndim))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = amp.cast("group_norm", x, weight, bias)
    ch = _ch_axis(x.ndim, data_format)
    v = torch.movedim(x, ch, 1) if ch != 1 else x
    N, C = v.shape[:2]
    rest = tuple(v.shape[2:])
    g = v.reshape((N, num_groups, C // num_groups) + rest).float()
    dims = tuple(range(2, g.ndim))
    var, mean = torch.var_mean(g, dim=dims, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).to(x.dtype).reshape(v.shape)
    shape = (1, C) + (1,) * len(rest)
    if weight is not None:
        out = out * weight.to(x.dtype).reshape(shape)
    if bias is not None:
        out = out + bias.to(x.dtype).reshape(shape)
    return torch.movedim(out, 1, ch) if ch != 1 else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel normalisation over the spatial dims (the
    running statistics are accepted and not read, as in the reference)."""
    x, weight, bias = amp.cast("instance_norm", x, weight, bias)
    ch = _ch_axis(x.ndim, data_format)
    dims = tuple(i for i in range(x.ndim) if i not in (0, ch))
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[ch] = -1
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    x, = amp.cast("normalize", x)
    norm = torch.sum(x.abs() ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum of x^2 over size neighbouring channels) **
    beta`` (the window padded by ``size // 2`` below, ``(size - 1) // 2``
    above)."""
    x, = amp.cast("local_response_norm", x)
    ch = _ch_axis(x.ndim, data_format)
    sq = torch.movedim(torch.square(x), ch, -1)
    sq = torch.nn.functional.pad(sq, (size // 2, (size - 1) // 2))
    win = torch.movedim(sq.unfold(-1, size, 1).sum(-1), -1, ch)
    return x / torch.pow(k + alpha * win, beta)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last dim: the mean square in f32, the normalised
    value cast back to x's dtype, then times ``weight`` under the usual
    type promotion (a bf16 weight times an f32 x gives f32, as in jnp).
    Under ``amp.auto_cast`` at O2 it runs in the amp dtype."""
    x, weight = amp.cast("rms_norm", x, weight)
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
