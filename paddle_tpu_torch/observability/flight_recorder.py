"""Hang/crash flight recorder: a fixed-size ring of recent spans/events
that dumps to ``PADDLE_FLIGHT_DIR`` when the process dies or wedges
(counterpart of ``paddle_tpu/observability/flight_recorder.py``, a copy of
it over this package's tracing and metrics; the dump schema is the
reference's, so one reader serves both).

This is the post-mortem story a multi-host serving deployment needs (the
standard failure mode: the scheduler thread wedges or a rank SIGTERMs and
there are zero forensics).  Three triggers, all writing the same JSON
schema:

- **signals** — :func:`install_crash_handlers` chains SIGTERM/SIGABRT (and
  any extra) handlers that dump before re-delivering the signal;
- **unhandled exceptions** — ``sys.excepthook`` / ``threading.excepthook``
  wrappers dump with the traceback attached;
- **watchdogs** — :mod:`.watchdog` calls :meth:`FlightRecorder.dump` when
  the serving scheduler exceeds its deadline; :mod:`.memory` on an OOM.

Enabling (:func:`enable`, or automatically at import when
``PADDLE_FLIGHT_DIR`` is set) arms the recorder as a tracing sink: every
finished span lands in the ring, so the dump shows the last N operations
before the event plus every span still open (the stuck one included).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import signal as _signal
import sys
import tempfile
import threading
import traceback
from time import time as _wall

from ..profiler import metrics as _metrics
from . import tracing as _tracing

_DEFAULT_CAPACITY = 4096

_RECORDER: "FlightRecorder | None" = None
_LOCK = threading.Lock()
# tracked separately: a first call from a worker thread installs the
# exception hooks but must NOT mark the signal handlers done (they can only
# install from the main thread; a later main-thread call retries them).
# Signals are tracked by NAME so a later call can chain additional ones.
_EXC_HOOKS_INSTALLED = False
_INSTALLED_SIGNALS: set = set()


class FlightRecorder:
    """Fixed-size ring of recent events + the dump recipe."""

    def __init__(self, dir=None, capacity=_DEFAULT_CAPACITY):
        self.dir = dir or os.environ.get("PADDLE_FLIGHT_DIR")
        self._ring = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.last_dump_path = None
        self._m_dumps = _metrics.counter(
            "observability.flight_dumps", "flight-record dumps by reason")

    # ----------------------------------------------------------- recording
    # the ring lock covers append vs snapshot: deque appends are atomic,
    # but list(deque) during a concurrent append raises 'mutated during
    # iteration' — and a dump that silently loses that race is a dump
    # that's missing at exactly the moment spans are flowing
    def record(self, kind, name, **data):
        """Append one event to the ring (cheap: a locked deque append)."""
        with self._lock:
            self._ring.append({"time": _wall(), "kind": kind, "name": name,
                               "data": data})

    def record_span(self, sp):
        entry = {"time": sp.wall_t0, "kind": "span", "name": sp.name,
                 "data": {"trace_id": sp.trace_id,
                          "span_id": sp.span_id,
                          "duration": sp.duration,
                          "tid": sp.tid,
                          "attrs": {k: v for k, v in sp.attrs.items()
                                    if isinstance(v, (str, int, float, bool,
                                                      list))}}}
        with self._lock:
            self._ring.append(entry)

    def snapshot(self, lock_timeout=None):
        """Ring copy; ``lock_timeout`` bounds the wait on the crash path
        (the interrupted thread may hold the lock mid-append)."""
        acquired = self._lock.acquire(timeout=lock_timeout) \
            if lock_timeout is not None else self._lock.acquire()
        try:
            try:
                return list(self._ring)
            except RuntimeError:  # lockless copy raced an append
                return []
        finally:
            if acquired:
                self._lock.release()

    # --------------------------------------------------------------- dump
    def dump(self, reason, extra=None, path=None, from_signal=False):
        """Write the ring + every in-flight span as one JSON file.  Never
        raises — a dump failing must not mask the original crash.

        ``from_signal``: the handler runs ON the interrupted thread, which
        may hold any non-reentrant lock (tracing registry, a metric child)
        mid-critical-section — so the signal path bounds the span-registry
        lock wait and skips the metric increment entirely; blocking there
        would deadlock the dying process."""
        try:
            d = self.dir or os.path.join(tempfile.gettempdir(),
                                         "paddle_flight")
            os.makedirs(d, exist_ok=True)
            if path is None:
                n = next(self._seq)
                path = os.path.join(
                    d, f"flight_pid{os.getpid()}_{reason}_{n}.json")
            doc = {
                "schema": "paddle_tpu.observability.flight.v1",
                "reason": reason,
                "time": _wall(),
                "pid": os.getpid(),
                "rank": _tracing.safe_rank(),
                "open_spans": _tracing.open_spans(
                    lock_timeout=0.25 if from_signal else None),
                "events": self.snapshot(
                    lock_timeout=0.25 if from_signal else None),
            }
            if extra:
                doc["extra"] = extra
            with open(path, "w") as f:
                json.dump(doc, f, default=repr)
            self.last_dump_path = path
            if not from_signal:
                self._m_dumps.inc(reason=reason)
            return path
        except Exception:
            return None


# ------------------------------------------------------------ global wiring
def get_flight_recorder() -> FlightRecorder:
    """The process recorder (created unarmed on first use)."""
    global _RECORDER
    if _RECORDER is None:
        with _LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def enable(dir=None, capacity=None) -> FlightRecorder:
    """Arm the recorder as a tracing sink (spans start filling the ring)."""
    rec = get_flight_recorder()
    if dir is not None:
        rec.dir = dir
    if capacity is not None:
        with rec._lock:
            rec._ring = collections.deque(rec._ring, maxlen=int(capacity))
    with _tracing._LOCK:
        _tracing._FLIGHT = rec
        _tracing._refresh_active()
    return rec


def disable():
    with _tracing._LOCK:
        _tracing._FLIGHT = None
        _tracing._refresh_active()


def enabled() -> bool:
    return _tracing._FLIGHT is not None


def maybe_enable_from_env():
    """Arm + install crash handlers when ``PADDLE_FLIGHT_DIR`` is set (the
    production spelling: export one env var, get forensics)."""
    if not os.environ.get("PADDLE_FLIGHT_DIR"):
        return None
    rec = enable()
    install_crash_handlers()
    return rec


# -------------------------------------------------------- crash-time hooks
def handle_exception(exc_type, exc, tb):
    """Dump an unhandled exception (the excepthook body, callable directly
    by embedders that own their own hook chain)."""
    rec = get_flight_recorder()
    rec.record("exception", getattr(exc_type, "__name__", str(exc_type)),
               message=str(exc))
    return rec.dump("unhandled_exception", extra={
        "exception": "".join(
            traceback.format_exception(exc_type, exc, tb))[-20000:]})


def install_crash_handlers(signals=("SIGTERM", "SIGABRT"), exceptions=True):
    """Chain dump-then-continue handlers.  Idempotent per hook family;
    signal handlers can only be installed from the main thread, so a first
    call from a worker thread installs just the exception hooks and a
    later main-thread call (e.g. the next maybe_enable_from_env) still
    gets to install the signal handlers.  Returns True if anything new
    was installed."""
    global _EXC_HOOKS_INSTALLED
    installed = False
    with _LOCK:
        do_exc = exceptions and not _EXC_HOOKS_INSTALLED
        if do_exc:
            _EXC_HOOKS_INSTALLED = True
        if threading.current_thread() is threading.main_thread():
            todo_signals = [n for n in signals if n not in _INSTALLED_SIGNALS]
            _INSTALLED_SIGNALS.update(todo_signals)
        else:
            todo_signals = []

    if do_exc:
        installed = True
        prev_sys = sys.excepthook

        def _sys_hook(exc_type, exc, tb):
            handle_exception(exc_type, exc, tb)
            prev_sys(exc_type, exc, tb)

        sys.excepthook = _sys_hook

        prev_thread = threading.excepthook

        def _thread_hook(args):
            handle_exception(args.exc_type, args.exc_value, args.exc_traceback)
            prev_thread(args)

        threading.excepthook = _thread_hook

    if todo_signals:
        installed = True
        for name in todo_signals:
            sig = getattr(_signal, name, None)
            if sig is None:
                continue
            try:
                prev = _signal.getsignal(sig)

                def _handler(signum, frame, _prev=prev):
                    get_flight_recorder().dump(
                        f"signal_{_signal.Signals(signum).name}",
                        from_signal=True)
                    if _prev == _signal.SIG_IGN:
                        return  # deliberately ignored signal: dump, survive
                    if callable(_prev) and _prev != _signal.SIG_DFL:
                        _prev(signum, frame)
                    else:
                        # restore the default disposition and re-deliver so
                        # the process still dies with the right signal
                        _signal.signal(signum, _signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

                _signal.signal(sig, _handler)
            except (ValueError, OSError):
                pass
    return installed
