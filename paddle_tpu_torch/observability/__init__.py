"""paddle_tpu_torch.observability — tracing, forensics and telemetry over
the metrics registry of :mod:`paddle_tpu_torch.profiler` (counterpart of
``paddle_tpu/observability``).

- :mod:`.tracing` — ``span()`` with OTLP-convention trace/span ids, the
  per-rank :class:`Tracer`, chrome-trace + OTLP-JSON export, and
  :func:`merge_rank_traces`.  Trace ids propagate from
  ``ServingEngine.submit()`` through prefill and every decode iteration.
- :mod:`.flight_recorder` + :mod:`.watchdog` — a fixed-size ring of
  recent spans/events that dumps to ``PADDLE_FLIGHT_DIR`` on
  SIGTERM/SIGABRT, unhandled exceptions, OOMs and watchdog fires; the
  :class:`~.watchdog.CollectiveWatchdog` brackets every eager collective
  and the :class:`~.watchdog.ServingWatchdog` catches a wedged scheduler
  thread.
  :mod:`.faults` provides the injection hooks the tests use.
- :mod:`.telemetry` — ``observability.serve(port)``: a stdlib HTTP thread
  exposing ``/metrics`` (Prometheus text), ``/healthz`` and ``/statusz``.
  Also armed by ``ServingEngine(telemetry_port=...)`` or
  ``PADDLE_TELEMETRY_PORT``.
- :mod:`.memory` — the device-memory ledger, OOM forensics and the
  ``PADDLE_HBM_BUDGET_BYTES`` admission pre-flight's budget.
- :mod:`.numerics` — tensor stats, the numerics stream and its anomaly
  engine, the numeric guard's hooks.
- :mod:`.slo` — :class:`~.slo.SLOPolicy` and :class:`~.slo.SLOAccountant`.
- :mod:`.programs` — the program ledger (:class:`ProgramLedger`: every
  mint of a serving, generate or TrainStep program, its first-dispatch
  stall and who paid it) and :class:`WarmupManifest`.
- :mod:`.perf` — the per-program roofline table (:class:`ProgramTable`).

Env flags (README, the port's "Observability" part):
``PADDLE_FLIGHT_DIR``, ``PADDLE_TELEMETRY_PORT``,
``PADDLE_HBM_BUDGET_BYTES``, ``PADDLE_METRICS_DIR``.
"""

from __future__ import annotations

from . import (  # noqa: F401
    faults, flight_recorder, memory, numerics, perf, programs, slo,
    telemetry, tracing, watchdog,
)
from .faults import FaultPlan  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder, get_flight_recorder, install_crash_handlers,
)
from .memory import MemoryLedger, MemoryWatchdog  # noqa: F401
from .perf import ProgramTable  # noqa: F401
from .numerics import (  # noqa: F401
    NumericsMonitor, TensorCheckerConfig, check_numerics,
    collect_operator_stats, disable_tensor_checker, enable_tensor_checker,
)
from .programs import ProgramLedger, WarmupManifest  # noqa: F401
from .slo import RequestTimeline, SLOAccountant, SLOPolicy  # noqa: F401
from .telemetry import (  # noqa: F401
    TelemetryServer, add_health_provider, add_status_provider, serve,
)
from .tracing import (  # noqa: F401
    Span, Tracer, current_trace_id, event, merge_rank_traces, new_trace_id,
    open_spans, span,
)
from .watchdog import (  # noqa: F401
    CollectiveWatchdog, ServingWatchdog, add_fire_listener,
    remove_fire_listener,
)

__all__ = [
    "tracing", "flight_recorder", "watchdog", "telemetry", "faults",
    "slo", "memory", "numerics", "perf", "programs", "ProgramLedger",
    "WarmupManifest", "ProgramTable", "NumericsMonitor", "TensorCheckerConfig",
    "enable_tensor_checker", "disable_tensor_checker", "check_numerics",
    "collect_operator_stats", "SLOPolicy", "SLOAccountant", "RequestTimeline", "MemoryLedger",
    "MemoryWatchdog", "Span", "Tracer", "span", "event", "new_trace_id",
    "current_trace_id", "open_spans", "merge_rank_traces",
    "FlightRecorder", "get_flight_recorder", "install_crash_handlers",
    "CollectiveWatchdog", "ServingWatchdog", "add_fire_listener",
    "remove_fire_listener",
    "FaultPlan", "TelemetryServer", "serve", "add_status_provider",
    "add_health_provider",
]

# production spelling: export PADDLE_FLIGHT_DIR=/some/dir and importing any
# instrumented module arms the crash ring + signal/exception dumps
flight_recorder.maybe_enable_from_env()
