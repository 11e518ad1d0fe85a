"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``).

``Dropout`` takes paddle's ``axis`` and ``mode``; ``Embedding`` is
``torch.nn``'s table looked up by ``functional.embedding`` (the amp cast
and paddle's padding rule: the output is zero at ``padding_idx``).
``Linear`` keeps torch's ``[out, in]`` weight; paddle stores ``[in,
out]``, and ``text.models.convert`` transposes on load.  ``Identity``,
``Flatten`` (``start_axis`` / ``stop_axis``), the ``Pad*`` /
``ZeroPad*`` layers (:func:`..functional.common.pad` with its
``data_format``) and ``ChannelShuffle`` are the reference's.
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
    bf16 weight runs in f32, on an f32 copy of the weight)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.weight.__class__ = TransposedParameter

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
    numerics layer tap sees it as the reference's ``Embedding`` layer."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None):
        super().__init__(num_embeddings, embedding_dim, padding_idx)

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
