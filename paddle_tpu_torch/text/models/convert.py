"""Weights carried across from the TPU package.

:func:`load_paddle_tpu_state_dict` takes ``paddle_tpu``'s
``model.state_dict()`` as numpy arrays under paddle's names
(``gpt.word_embeddings.weight``, ``gpt.layers.0.qkv.weight``, ...) — the
caller converts them, so this module never imports the JAX package — and
loads them into the port's model of the same structure.  Paddle's
``Linear`` stores ``[in, out]``; torch's ``[out, in]``, so those weights
are transposed.  Every key and shape is checked both ways.
"""

from __future__ import annotations

import numpy as np
import torch


def load_paddle_tpu_state_dict(model: torch.nn.Module, state: dict) -> None:
    """Copy ``state`` (name -> numpy array) into ``model`` in place, cast
    to each parameter's dtype and device.  Raises ``KeyError`` on a missing
    or extra key and ``ValueError`` on a shape mismatch."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {extra}")
    linear_weights = {f"{name}.weight" for name, m in model.named_modules()
                      if isinstance(m, torch.nn.Linear)}
    with torch.no_grad():
        for key, dst in own.items():
            arr = np.asarray(state[key])
            if key in linear_weights:
                arr = arr.T
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} (after "
                                 f"layout conversion) != {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr))
