"""Weights carried across from and back to the TPU package.

:func:`load_paddle_tpu_state_dict` takes ``paddle_tpu``'s
``model.state_dict()`` as numpy arrays under paddle's names
(``gpt.word_embeddings.weight``, ``gpt.layers.0.qkv.weight``, ...) — the
caller converts them, so this module never imports the JAX package — and
loads them into the port's model of the same structure.  Paddle's
``Linear`` stores ``[in, out]``; torch's ``[out, in]``, so those weights
are transposed, and so are ``Int8Linear``'s ``weight_int8`` buffers.
(``Int8Linear.w_scale`` is an attribute, not state: a converted model is
made by converting the float model with
``serving.quant.quantize_model_weights``.)  :func:`export_paddle_tpu_state_dict` is the inverse, so
trained weights can be held against the JAX model's.  Every key and shape
is checked both ways.

A model wrapped by ``quantization.QAT`` / ``PTQ`` carries the TPU
package's names: ``<layer>.inner.weight`` is a Linear weight like any
other (transposed), and the quanters' 0-d float32 buffers
(``<layer>.act_quanter.scale``, ``.weight_quanter.scale``, an observer's
``.absmax``) pass as scalars.
"""

from __future__ import annotations

import numpy as np
import torch


def load_paddle_tpu_state_dict(model: torch.nn.Module, state: dict) -> None:
    """Copy ``state`` (name -> numpy array) into ``model`` in place, cast
    to each parameter's dtype and device.  Raises ``KeyError`` on a missing
    or extra key and ``ValueError`` on a shape mismatch."""
    own = model.state_dict()
    _check_keys(own, state)
    linear_weights = _linear_weights(model)
    with torch.no_grad():
        for key, dst in own.items():
            arr = np.asarray(state[key])
            if key in linear_weights:
                arr = arr.T
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} (after "
                                 f"layout conversion) != {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr))


def export_paddle_tpu_state_dict(model: torch.nn.Module, expected=None) -> dict:
    """``model``'s weights as ``{paddle name: numpy array}`` in paddle's
    layout (``Linear`` weights ``[in, out]``), float32 for floating ones.
    With ``expected`` (name -> array, e.g. the JAX model's state) the keys
    and shapes must match: ``KeyError`` / ``ValueError`` otherwise."""
    linear_weights = _linear_weights(model)
    out = {}
    for key, t in model.state_dict().items():
        arr = t.detach().cpu()
        arr = (arr.float() if arr.is_floating_point() else arr).numpy()
        out[key] = arr.T if key in linear_weights else arr
    if expected is not None:
        _check_keys(out, expected)
        for key, arr in out.items():
            want = tuple(np.shape(expected[key]))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: exported shape {tuple(arr.shape)} "
                                 f"!= expected {want}")
    return out


def _check_keys(own, other):
    missing = sorted(set(own) - set(other))
    extra = sorted(set(other) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {extra}")


def _linear_weights(model):
    """State-dict keys kept ``[out, in]`` here and ``[in, out]`` in paddle."""
    from ...quantization import Int8Linear

    keys = set()
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, torch.nn.Linear):
            keys.add(f"{pre}weight")
        elif isinstance(m, Int8Linear):
            keys.add(f"{pre}weight_int8")
    return keys
