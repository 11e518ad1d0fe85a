"""Normalisation layers (counterpart of ``paddle_tpu/nn/layers/norm.py``).

The batch norms keep the reference's names: parameters ``weight`` /
``bias`` and the buffers ``_mean`` / ``_variance`` (float32, no
``num_batches_tracked``), so ``state_dict()`` keys equal the reference's
both ways; :func:`..functional.norm.batch_norm` updates the buffers in
place in training (momentum 0.9 on the old value, the biased variance).
The instance norms' affine parameters are ``scale`` / ``bias``, as there.
``weight_attr`` / ``bias_attr``: None, ``False`` (no parameter) or an
object with an ``initializer`` (paddle's ``ParamAttr``).
"""

from __future__ import annotations

import torch

from .. import functional as F
from ..functional.norm import rms_norm
from .common import make_parameter


class LayerNorm(torch.nn.Module):
    """Layer norm over the last dims with the TPU package's numerics:
    statistics in f32, the normalised value cast back to the input dtype
    before the affine, which runs in the input dtype.  Under
    ``amp.auto_cast`` at O2 it runs in the amp dtype (O1 leaves it).
    ``weight_attr`` / ``bias_attr`` as the module says (``False``: that
    half of the affine is dropped)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = make_parameter(self.normalized_shape, weight_attr, 1.0)
        self.bias = make_parameter(self.normalized_shape, bias_attr, 0.0)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class RMSNorm(torch.nn.Module):
    """RMSNorm over the last dim (:func:`..functional.norm.rms_norm`), its
    weight all ones unless ``weight_attr`` draws it."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = make_parameter((hidden_size,), weight_attr, 1.0)

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class SpectralNorm(torch.nn.Module):
    """``weight / sigma``, ``sigma`` the largest singular value of
    ``weight`` seen as a ``[shape[dim], -1]`` matrix, estimated by
    ``power_iters`` rounds of power iteration from the ``weight_u`` /
    ``weight_v`` buffers (drawn N(0, 1) at construction and never written,
    as in the reference; the gradient flows through the iteration)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.register_buffer("weight_u", torch.randn(h, dtype=dtype))
        self.register_buffer("weight_v", torch.randn(w, dtype=dtype))

    def forward(self, weight):
        dim, eps = self._dim, self._eps
        wm = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        sigma = u @ wm @ v
        return weight / sigma


class _BatchNormBase(torch.nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = make_parameter([num_features], weight_attr, 1.0)
        self.bias = make_parameter([num_features], bias_attr, 0.0)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm``: ``act`` (a functional's name,
    e.g. ``"relu"``) follows the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class _SumOverRanks(torch.autograd.Function):
    """Sum over the ranks of ``group`` forward, and the gradient summed over
    them backward (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed.communication import all_reduce

        ctx.group = group
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        from ...distributed.communication import all_reduce

        return all_reduce(g.contiguous().clone(), group=ctx.group), None


def _sync_group():
    """The ranks a ``SyncBatchNorm`` takes its statistics over: the hybrid
    topology's dp group, else every rank; None in a world of one."""
    from ...distributed import is_initialized
    from ...distributed.parallel import _dp_group

    if not is_initialized():
        return None
    g = _dp_group()
    return g if g.nranks > 1 else None


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the whole batch: in training, the statistics are
    the global batch's over every data-parallel rank (``all_reduce`` of
    the sum, then of the squared deviations, two passes as
    ``var_mean``), as the reference's batch norm over a batch laid across
    its mesh gets them.  In a world of one it is :class:`BatchNorm2D`."""

    def forward(self, x):
        group = _sync_group()
        if group is None or not self.training or self._use_global_stats:
            return super().forward(x)
        from ... import amp
        from ..functional.norm import _ch_axis

        x, weight, bias = amp.cast("batch_norm", x, self.weight, self.bias)
        ch = _ch_axis(x.ndim, self._data_format)
        reduce = tuple(i for i in range(x.ndim) if i != ch)
        shape = [1] * x.ndim
        shape[ch] = -1
        xf = x.float()
        count = torch.tensor(float(xf.numel() // xf.shape[ch]),
                             device=x.device)
        from ...distributed.communication import all_reduce

        count = all_reduce(count, group=group)
        mean = _SumOverRanks.apply(xf.sum(dim=reduce), group) / count
        var = _SumOverRanks.apply(
            torch.square(xf - mean.reshape(shape)).sum(dim=reduce),
            group) / count
        scale = torch.rsqrt(var + self._epsilon)
        if weight is not None:
            scale = scale * weight.float()
        offset = -mean * scale
        if bias is not None:
            offset = offset + bias.float()
        out = x * scale.to(x.dtype).reshape(shape) \
            + offset.to(x.dtype).reshape(shape)
        with torch.no_grad():
            m = self._momentum
            self._mean.copy_(m * self._mean + (1 - m)
                             * mean.detach().to(self._mean.dtype))
            self._variance.copy_(m * self._variance + (1 - m)
                                 * var.detach().to(self._variance.dtype))
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm under it (itself included)
        replaced by a ``SyncBatchNorm`` holding the same parameters and
        running statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                None if layer.weight is not None else False,
                                None if layer.bias is not None else False,
                                layer._data_format)
            out.to(layer._mean.device)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    if getattr(layer, name) is not None:
                        getattr(out, name).copy_(getattr(layer, name))
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(torch.nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = make_parameter([num_channels], weight_attr, 1.0)
        self.bias = make_parameter([num_channels], bias_attr, 0.0)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(torch.nn.Module):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.scale = make_parameter([num_features], weight_attr, 1.0)
            self.bias = make_parameter([num_features], bias_attr, 0.0)
        else:
            self.scale = self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(torch.nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)
