"""paddle_tpu_torch.profiler — the host-side observability primitives
(counterpart of ``paddle_tpu/profiler``).

- :mod:`.metrics` — process-wide metrics registry (counters / gauges /
  histograms with labels) with JSONL + Prometheus-text exporters and an
  env-gated background flusher (``PADDLE_METRICS_DIR``); the port's own
  registry, apart from the reference's.
- :mod:`.events` — the host ``RecordEvent`` tree; a ``RecordEvent``
  region also shows in a ``torch.profiler`` trace.

The reference's ``Profiler`` context (``profiler/profiler.py``) is not
ported yet (ROADMAP Queue 1 item 6).  Span tracing, the flight recorder
and the ``/metrics`` ``/healthz`` ``/statusz`` endpoint live in
:mod:`paddle_tpu_torch.observability`.
"""

from __future__ import annotations

from . import events, metrics  # noqa: F401
from .events import RecordEvent  # noqa: F401

__all__ = ["RecordEvent", "events", "metrics"]
