"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``).

``Dropout`` takes paddle's ``axis`` and ``mode``; ``Embedding`` is
``torch.nn``'s table looked up by ``functional.embedding`` (the amp cast
and paddle's padding rule: the output is zero at ``padding_idx``).
``Linear`` keeps torch's ``[out, in]`` weight; paddle stores ``[in,
out]``, and ``text.models.convert`` transposes on load.  ``Identity``,
``Flatten`` (``start_axis`` / ``stop_axis``), ``Unflatten``, the
``Pad*`` / ``ZeroPad*`` layers (:func:`..functional.common.pad` with its
``data_format``), ``ChannelShuffle``, the ``Upsample`` family, pixel
(un)shuffle, ``Unfold`` / ``Fold``, ``Bilinear`` (weight ``[out, in1,
in2]``, Xavier-uniform over those fans, bias zero, as the reference),
the distances and the dropout family (``Dropout1D/2D/3D``,
``AlphaDropout``, ``FeatureAlphaDropout``; masks from ``generator``,
torch's default generator of the input's device when None) are the
reference's.
"""

from __future__ import annotations

import torch

from ... import amp


class TransposedParameter(torch.nn.Parameter):
    """A parameter kept ``[out, in]`` here where paddle keeps ``[in, out]``
    (a ``Linear``'s weight, ``weight_norm``'s ``weight_v``): ``nn.utils``
    and the weight converter read the layout off the tensor.  A subclass,
    not an attribute: ``copy.deepcopy`` keeps a parameter's type and drops
    its attributes."""

    transposed_layout = True

    def __reduce_ex__(self, proto):     # pickling keeps the layout too
        return TransposedParameter, (self.data, self.requires_grad)


def mark_transposed(t):
    """Tag ``t`` (a weight computed from a :class:`TransposedParameter`)
    as kept in the transposed layout; returns it."""
    t.transposed_layout = True
    return t


def is_transposed(t):
    """Whether the 2-D tensor ``t`` is kept ``[out, in]`` (see
    :class:`TransposedParameter` and :func:`mark_transposed`)."""
    return t.ndim == 2 and getattr(t, "transposed_layout", False)


def promote(first, *rest):
    """The tensors (``rest`` may hold None, which passes) cast to their
    common promoted dtype, as jnp promotes the operands of a matmul or an
    einsum; each already in it is returned as it is."""
    dt = first.dtype
    if all(t is None or t.dtype == dt for t in rest):
        return (first,) + rest
    for t in rest:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t is None or t.dtype == dt else t.to(dt)
                 for t in (first,) + rest)


def make_parameter(shape, attr=None, default=0.0):
    """A float32 parameter of paddle's ``shape`` for a layer's
    ``weight_attr`` / ``bias_attr``: None when ``attr is False``; drawn by
    ``attr.initializer`` when it has one (paddle's ``ParamAttr``), else by
    ``default`` (an initializer, or a constant)."""
    if attr is False:
        return None
    init = getattr(attr, "initializer", None) or default
    if callable(init):
        value = init(tuple(shape), torch.float32)
    else:
        value = torch.full(tuple(shape), float(init))
    return torch.nn.Parameter(value.detach().clone())


class Linear(torch.nn.Linear):
    """``y = x W^T + b``; weights Xavier-uniform and bias zero, as paddle's
    defaults.  Under ``amp.auto_cast`` it runs in the amp dtype (white
    list).  Outside it, an input and a weight of different float dtypes
    meet in their promoted dtype, as ``jnp.matmul`` does (an f32 x times a
    bf16 weight runs in f32, on an f32 copy of the weight).  Paddle's
    ``weight_attr`` / ``bias_attr`` are taken too: ``bias_attr=False``
    drops the bias, an object with an ``initializer`` (``nn.ParamAttr``)
    draws that tensor (the weight in paddle's ``[in, out]`` layout)."""

    def __init__(self, *args, weight_attr=None, bias_attr=None, name=None,
                 **kwargs):
        if bias_attr is False:
            kwargs["bias"] = False
        super().__init__(*args, **kwargs)
        self.weight.__class__ = TransposedParameter
        w_init = getattr(weight_attr, "initializer", None)
        b_init = getattr(bias_attr, "initializer", None)
        with torch.no_grad():
            if w_init is not None:
                self.weight.copy_(w_init(tuple(self.weight.shape[::-1]),
                                         self.weight.dtype,
                                         device=self.weight.device).T)
            if b_init is not None and self.bias is not None:
                self.bias.copy_(b_init(tuple(self.bias.shape),
                                       self.bias.dtype,
                                       device=self.bias.device))

    def _apply(self, fn, recurse=True):
        # Module._apply re-makes a parameter it cannot convert in place
        # (``to_empty`` off the meta device) as a plain Parameter
        tagged = [n for n, p in self._parameters.items()
                  if p is not None and is_transposed(p)]
        super()._apply(fn, recurse)
        for n in tagged:
            self._parameters[n].__class__ = TransposedParameter
        return self

    def forward(self, x):
        return torch.nn.functional.linear(*promote(*amp.cast(
            "linear", x, self.weight, self.bias)))

    def reset_parameters(self):
        from ..initializer import _global_default

        w_init, b_init = _global_default(False), _global_default(True)
        with torch.no_grad():
            if w_init is None:
                torch.nn.init.xavier_uniform_(self.weight)
            else:   # drawn in paddle's [in, out] layout
                self.weight.copy_(w_init(tuple(self.weight.shape[::-1]),
                                         self.weight.dtype,
                                         device=self.weight.device).T)
            if self.bias is not None:
                if b_init is None:
                    torch.nn.init.zeros_(self.bias)
                else:
                    self.bias.copy_(b_init(tuple(self.bias.shape),
                                           self.bias.dtype,
                                           device=self.bias.device))


class Embedding(torch.nn.Embedding):
    """``torch.nn.Embedding`` looked up by :func:`..functional.embedding`:
    the table cast for the ``"embedding"`` op under ``amp.auto_cast`` (O2:
    the amp dtype; O1 leaves it), as paddle's lookup dispatches, and
    paddle's padding rule: with ``padding_idx`` the row starts at zero and
    the output is zero wherever ``ids == padding_idx``, whatever the row
    holds later (a loaded state may hold anything there), so the row gets
    no gradient (torch's own rule returns the row).  A module call, so the
    numerics layer tap sees it as the reference's ``Embedding`` layer.
    ``weight_attr`` with an initializer draws the table (the padding row
    then zeroed, as there); ``sparse`` is accepted as the reference
    accepts it, and the gradient stays dense."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__(num_embeddings, embedding_dim, padding_idx)
        if getattr(weight_attr, "initializer", None) is not None:
            with torch.no_grad():
                self.weight.copy_(make_parameter(self.weight.shape,
                                                 weight_attr))
                if self.padding_idx is not None:
                    self.weight[self.padding_idx].zero_()

    def forward(self, ids):
        from ..functional.common import embedding

        return embedding(ids, self.weight, self.padding_idx)


class Dropout(torch.nn.Module):
    """Paddle's ``Dropout(p, axis, mode)`` over
    :func:`..functional.common.dropout` (the mask from torch's default
    generator of the input's device)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        from ..functional.common import dropout

        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Identity(torch.nn.Module):
    def forward(self, x):
        return x


class Flatten(torch.nn.Module):
    """Dims ``start_axis`` .. ``stop_axis`` merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class _PadNd(torch.nn.Module):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        from ..functional.common import pad

        return pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad1D(_PadNd):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad3D(_PadNd):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ChannelShuffle(torch.nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        from ..functional.common import channel_shuffle

        return channel_shuffle(x, self.groups)


class Unflatten(torch.nn.Module):
    """Dim ``axis`` expanded into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        return torch.unflatten(x, self.axis, tuple(self.shape))


class Upsample(torch.nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        from ..functional.common import interpolate

        return interpolate(x, self.size, self.scale_factor, self.mode,
                           self.align_corners, self.align_mode,
                           self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class PixelShuffle(torch.nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        from ..functional.common import pixel_shuffle

        return pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(torch.nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        from ..functional.common import pixel_unshuffle

        return pixel_unshuffle(x, self.downscale_factor, self.data_format)


class Unfold(torch.nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        from ..functional.common import unfold

        return unfold(x, *self.args)


class Fold(torch.nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        from ..functional.common import fold

        return fold(x, self.output_sizes, *self.args)


class Bilinear(torch.nn.Module):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[o]``; ``weight``
    ``[out, in1, in2]`` (the reference's layout, passed as it is by the
    weight converter), Xavier-uniform over its fans (``in1 * in2`` in,
    ``out * in2`` out, as the reference's ``_fans``), bias zero."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        from .. import initializer as I

        self.weight = make_parameter([out_features, in1_features,
                                      in2_features], weight_attr,
                                     I.XavierUniform())
        self.bias = make_parameter([out_features], bias_attr, 0.0)

    def forward(self, x1, x2):
        from ..functional.common import bilinear

        return bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(torch.nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        from ..functional.common import cosine_similarity

        return cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(torch.nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        from ..functional.common import pairwise_distance

        return pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class _DropoutNd(torch.nn.Module):
    """A dropout layer whose mask shares one draw along the dims its
    ``_axis`` leaves out; ``generator`` as in
    :func:`..functional.common.dropout`."""

    def __init__(self, p=0.5, data_format=None, name=None, generator=None):
        super().__init__()
        self.p, self.generator = p, generator
        if data_format is not None:
            self.data_format = data_format

    def forward(self, x):
        from ..functional.common import dropout

        return dropout(x, self.p, axis=self._axis(), training=self.training,
                       generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout1D(_DropoutNd):
    """Whole length-L channels dropped (one draw per (N, C))."""

    def __init__(self, p=0.5, data_format="NCL", name=None, generator=None):
        super().__init__(p, data_format, name, generator)

    def _axis(self):
        return [0, 1] if self.data_format == "NCL" else [0, 2]


class Dropout2D(_DropoutNd):
    def __init__(self, p=0.5, data_format="NCHW", name=None, generator=None):
        super().__init__(p, data_format, name, generator)

    def _axis(self):
        return [0, 1] if self.data_format == "NCHW" else [0, 3]


class Dropout3D(_DropoutNd):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, generator=None):
        super().__init__(p, data_format, name, generator)

    def _axis(self):
        return [0, 1] if self.data_format == "NCDHW" else [0, 4]


class AlphaDropout(torch.nn.Module):
    def __init__(self, p=0.5, name=None, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        from ..functional.common import alpha_dropout

        return alpha_dropout(x, self.p, training=self.training,
                             generator=self.generator)


class FeatureAlphaDropout(AlphaDropout):
    """Alpha dropout of whole feature maps (one draw per (N, C))."""

    def forward(self, x):
        from ..functional.common import feature_alpha_dropout

        return feature_alpha_dropout(x, self.p, training=self.training,
                                     generator=self.generator)
