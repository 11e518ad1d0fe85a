"""paddle_tpu_torch.profiler — the host-side observability primitives
(counterpart of ``paddle_tpu/profiler``).

- :mod:`.metrics` — process-wide metrics registry (counters / gauges /
  histograms with labels) with JSONL + Prometheus-text exporters and an
  env-gated background flusher (``PADDLE_METRICS_DIR``); the port's own
  registry, apart from the reference's.
- :mod:`.events` — the host ``RecordEvent`` tree; a ``RecordEvent``
  region also shows in a ``torch.profiler`` trace.
- :mod:`.profiler` — the reference-shaped ``Profiler`` context
  (CLOSED / READY / RECORD scheduler, ``on_trace_ready`` handlers, per-op
  summary tables, chrome-trace export, ``load_profiler_result``) over
  ``torch.profiler`` for the device timeline.

Env flags: ``PADDLE_PROFILER_DIR`` (trace output dir),
``PADDLE_METRICS_DIR`` / ``PADDLE_METRICS_FLUSH_SECS`` (metrics flusher),
``PADDLE_PEAK_FLOPS`` (TrainStep MFU).  Span tracing, the flight recorder
and the ``/metrics`` ``/healthz`` ``/statusz`` endpoint live in
:mod:`paddle_tpu_torch.observability`.
"""

from __future__ import annotations

from . import events, metrics  # noqa: F401
from .events import RecordEvent  # noqa: F401
from .profiler import (  # noqa: F401
    Profiler, ProfilerResult, ProfilerState, ProfilerTarget, SummaryView,
    export_chrome_tracing, export_protobuf, load_profiler_result,
    make_scheduler,
)

__all__ = [
    "Profiler", "ProfilerResult", "ProfilerState", "ProfilerTarget",
    "SummaryView", "RecordEvent", "make_scheduler", "export_chrome_tracing",
    "export_protobuf", "load_profiler_result", "events", "metrics",
]
