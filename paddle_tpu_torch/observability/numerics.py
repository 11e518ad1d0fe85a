"""Numerics observability, the serving engine's part (counterpart of
``paddle_tpu/observability/numerics.py``: the numeric guard's default and
the ``numerics.nan_inject`` fault site; the numerics stream, the tensor
checker's probes and the anomaly engine are not ported yet).

- :func:`serving_guard_default` — what ``ServingEngine(numeric_guard=None)``
  resolves to: the active :class:`TensorCheckerConfig`'s ``serving_guard``
  (off unless :func:`enable_tensor_checker` asked for it);
- :func:`consume_nan_inject` — the ``numerics.nan_inject`` site
  (:mod:`.faults`): NaN once per trip, else 0.0, which a guarded dispatch
  adds to the logits of lane :func:`nan_inject_row`, so arming a fault
  never changes what the dispatch computes for the other lanes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from . import faults as _faults

__all__ = ["TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "serving_guard_default",
           "consume_nan_inject", "set_nan_inject_row", "nan_inject_row"]


@dataclass
class TensorCheckerConfig:
    """The reference config's fields this port reads: ``enable`` and
    ``serving_guard`` (the default for ``ServingEngine(numeric_guard=
    None)``)."""

    enable: bool = True
    serving_guard: bool = False


_LOCK = threading.Lock()
_CONFIG: TensorCheckerConfig | None = None
_nan_trips_seen = 0
_NAN_INJECT_ROW = 0


def enable_tensor_checker(config=None, **kw):
    """Install ``config`` (or ``TensorCheckerConfig(**kw)``) as the active
    configuration; returns it."""
    global _CONFIG
    cfg = config if config is not None else TensorCheckerConfig(**kw)
    with _LOCK:
        _CONFIG = cfg
    return cfg


def disable_tensor_checker():
    global _CONFIG
    with _LOCK:
        _CONFIG = None


def serving_guard_default():
    cfg = _CONFIG
    return bool(cfg is not None and cfg.enable and cfg.serving_guard)


def consume_nan_inject():
    """The ``numerics.nan_inject`` site: returns ``float32("nan")`` when
    an armed fault tripped since the last call, else ``0.0``."""
    global _nan_trips_seen
    with _LOCK:
        # baseline BEFORE tripping: a re-armed site starts a fresh spec at
        # trips=0, so reading only after maybe() would swallow its first
        # trip (1 == the stale seen-count from the exhausted spec)
        before = _faults.trip_count("numerics.nan_inject")
        if before < _nan_trips_seen:       # faults.clear()/re-arm reset
            _nan_trips_seen = before
    _faults.maybe("numerics.nan_inject")
    trips = _faults.trip_count("numerics.nan_inject")
    with _LOCK:
        fired = trips > _nan_trips_seen
        _nan_trips_seen = trips
    return np.float32("nan") if fired else np.float32(0.0)


def set_nan_inject_row(row):
    """Serving: which batch lane the next tripped ``nan_inject`` poisons
    (default 0)."""
    global _NAN_INJECT_ROW
    _NAN_INJECT_ROW = int(row)


def nan_inject_row():
    return _NAN_INJECT_ROW
