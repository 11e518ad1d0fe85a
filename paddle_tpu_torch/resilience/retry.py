"""Failure classification and retry backoff (counterpart of
``paddle_tpu/resilience/retry.py``, a copy of it).

Deployments live with two failure populations:

- **transient** — a preempted host, a collective that timed out because a
  neighbour was being rescheduled, a dropped socket.  The response is a
  restart with backoff: the job is healthy, the world briefly was not.
- **fatal** — a shape error, an assertion in user code.  Restarting
  replays the same crash forever; the response is to surface it at once.

:func:`classify_failure` encodes that split (by type for this package's
own errors, by message pattern for errors from the runtime), and
:class:`RetryPolicy` is exponential backoff with a cap and seeded jitter.
The serving engine's restart path (``ServingEngine._loop``) is the
classification's consumer here.  The pattern table is the reference's,
unchanged: a CUDA error gets no special case, so an illegal-address
fault classifies as fatal and the engine aborts.
"""

from __future__ import annotations

import random
import zlib


class TransientError(RuntimeError):
    """Base for failures worth an automatic restart (preemption, flaky
    host, collective timeout).  Raise (or wrap into) one of these to tell
    the supervisors a retry is expected to succeed."""


class PreemptionError(TransientError):
    """The scheduler is taking the host/slice back (SIGTERM with notice,
    maintenance event)."""


class CollectiveTimeoutError(TransientError):
    """A collective exceeded its deadline — the canonical symptom of one
    rank dying mid-allreduce (the watchdog names the op; this error is what
    recovery acts on)."""


class EngineStoppedError(RuntimeError):
    """A serving request failed because its engine was stopped with the
    request still in flight (``ServingEngine.stop()`` without drain)."""


class NumericFault(RuntimeError):
    """Non-finite values detected by the numerics observability layer
    (the serving engine's numeric guard, :mod:`..observability.numerics`).  Neither transient nor
    fatal: retrying the SAME step replays the NaN, but the job is
    recoverable — supervisors classify this as ``"numeric"`` and roll
    back to the last VALID checkpoint instead of blindly retrying or
    surfacing it."""

    def __init__(self, msg="non-finite values detected", site=None,
                 stream=None, step=None):
        super().__init__(msg)
        self.site = site
        self.stream = stream
        self.step = step


# substrings (lowercased) in errors from the runtime and the
# coordination service that indicate the WORLD failed, not the program
_TRANSIENT_PATTERNS = (
    "deadline exceeded",
    "preempt",
    "unavailable",
    "socket closed",
    "connection reset",
    "connection refused",
    "broken pipe",
    "coordination service",
    "heartbeat",
    "barrier timed out",
    "peer down",
)

_TRANSIENT_TYPES = (TransientError, TimeoutError, ConnectionError,
                    BrokenPipeError)


def classify_failure(exc) -> str:
    """``"transient"`` (restart-worthy), ``"numeric"`` (roll back to the
    last valid checkpoint) or ``"fatal"`` (surface it)."""
    if isinstance(exc, NumericFault):
        return "numeric"
    if isinstance(exc, FloatingPointError):
        return "numeric"
    if isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    msg = str(exc).lower()
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return "transient"
    return "fatal"


class RetryPolicy:
    """Exponential backoff with a cap and seeded jitter.

    ``delay(attempt)`` for attempt 1, 2, 3, … is
    ``min(base * 2**(attempt-1), max_delay)`` scaled by a uniform jitter in
    ``[1-jitter, 1+jitter]`` and re-capped — so delays grow, never exceed
    the cap, and don't synchronize across hosts.  A given ``seed`` makes
    the jitter stream reproducible (the chaos tests assert exact delays).
    """

    def __init__(self, base_delay=1.0, max_delay=30.0, jitter=0.5,
                 seed=None):
        if not 0.0 <= float(jitter) <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay(self, attempt) -> float:
        d = min(self.base_delay * (2.0 ** max(int(attempt) - 1, 0)),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(min(d, self.max_delay), 0.0)


def derive_seed(*parts) -> int:
    """Stable small seed from arbitrary parts (fault plans, per-site rngs):
    crc32 of the repr-joined parts — reproducible across processes, unlike
    ``hash()`` under PYTHONHASHSEED randomization."""
    return zlib.crc32(":".join(repr(p) for p in parts).encode())
