"""The global seed (counterpart of ``paddle_tpu/framework/random.py``).

:func:`seed` seeds torch's default generators (the CPU's and every
card's, which dropout, the initializers and the models' weights draw
from) and the port's host generator (:func:`host_uniform`, for draws that
must be Python floats).  numpy's global generator is left alone, as in
the reference: the ``io`` samplers draw from it.
"""

from __future__ import annotations

import threading

import numpy as _np
import torch

_lock = threading.Lock()
_seed_value = 0
_host_rng = _np.random.default_rng(0)


def seed(s: int):
    """Set the global seed (``paddle.seed``).  Returns None."""
    global _seed_value, _host_rng
    with _lock:
        _seed_value = int(s)
        torch.manual_seed(int(s))
        _host_rng = _np.random.default_rng(int(s))


def get_seed() -> int:
    return _seed_value


def host_uniform() -> float:
    """One uniform [0, 1) draw as a Python float from the host generator
    that :func:`seed` reseeds."""
    with _lock:
        return float(_host_rng.random())
