"""Common layers (counterpart of ``paddle_tpu/nn/layers/common.py``).

``Dropout`` is ``torch.nn``'s own (paddle's defaults match it);
``Embedding`` is ``torch.nn``'s with the amp cast of the lookup.
``Linear`` keeps torch's ``[out, in]`` weight; paddle stores ``[in, out]``,
and ``text.models.convert`` transposes on load.
"""

from __future__ import annotations

import torch

from ... import amp


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


class Linear(torch.nn.Linear):
    """``y = x W^T + b``; weights Xavier-uniform and bias zero, as paddle's
    defaults.  Under ``amp.auto_cast`` it runs in the amp dtype (white
    list).  Outside it, an input and a weight of different float dtypes
    meet in their promoted dtype, as ``jnp.matmul`` does (an f32 x times a
    bf16 weight runs in f32, on an f32 copy of the weight)."""

    def forward(self, x):
        return torch.nn.functional.linear(*promote(*amp.cast(
            "linear", x, self.weight, self.bias)))

    def reset_parameters(self):
        torch.nn.init.xavier_uniform_(self.weight)
        if self.bias is not None:
            torch.nn.init.zeros_(self.bias)


class Embedding(torch.nn.Embedding):
    """``torch.nn.Embedding`` whose table is cast for the ``"embedding"``
    op under ``amp.auto_cast`` (O2: the amp dtype; O1 leaves it), as
    paddle's lookup dispatches.  A module call, so the numerics layer tap
    sees it as the reference's ``Embedding`` layer."""

    def forward(self, ids):
        w, = amp.cast("embedding", self.weight)
        return torch.nn.functional.embedding(
            ids, w, self.padding_idx, self.max_norm, self.norm_type,
            self.scale_grad_by_freq, self.sparse)
