"""Watchdog over a wedged serving scheduler (counterpart of
``paddle_tpu/observability/watchdog.py``: its :class:`ServingWatchdog`
and fire listeners; the ``CollectiveWatchdog`` waits for the port's
collectives).

:class:`ServingWatchdog` monitors one :class:`ServingEngine`: if work is
pending (queued requests or occupied slots) and the scheduler loop's
heartbeat (``engine._progress_t``, stamped once per iteration and after
every dispatch) has not advanced within the deadline, the scheduler is
wedged.  The fire, once per wedge (re-arming when progress resumes): a
loud log, a flight-recorder dump (``reason="serving_watchdog"``, the
engine's stats attached), an ``observability.watchdog_fires{kind=
"serving"}`` counter bump, a record appended to
:attr:`ServingWatchdog.fired` and every fire listener called.  It stays
quiet while the program ledger holds a compile window open for the
engine (:meth:`~.programs.ProgramLedger.compiling`: a first dispatch
building its kernels, running and capturing its program): slow, not
stuck.

The engine starts one when it is given ``watchdog_s``.
"""

from __future__ import annotations

import logging
import threading
from time import monotonic

from ..profiler import metrics as _metrics
from . import flight_recorder as _flight
from . import programs as _programs

logger = logging.getLogger("paddle_tpu_torch.observability")


def _fires_counter():
    return _metrics.counter(
        "observability.watchdog_fires", "watchdog triggers by kind/op")


# Fire listeners: detection-to-recovery wiring.  Listeners run on the
# monitor thread and must never raise into the fire path.
_FIRE_LISTENERS: list = []


def add_fire_listener(fn):
    """Register ``fn(kind, record)`` called on every watchdog fire
    (``kind`` is ``"serving"``)."""
    if fn not in _FIRE_LISTENERS:
        _FIRE_LISTENERS.append(fn)


def remove_fire_listener(fn):
    try:
        _FIRE_LISTENERS.remove(fn)
    except ValueError:
        pass


def _notify_fire(kind, record):
    for fn in list(_FIRE_LISTENERS):
        try:
            fn(kind, record)
        except Exception:
            logger.exception("watchdog fire listener failed (kind=%s)", kind)


class ServingWatchdog:
    """Wedged-scheduler detector for one :class:`ServingEngine`.

    Fires when the engine has pending work but its heartbeat is older
    than the deadline.  Re-arms after progress resumes, so a second wedge
    fires again."""

    def __init__(self, engine, deadline_s, poll_s=None, recorder=None):
        self.engine = engine
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(min(self.deadline_s / 4, 5.0), 0.02)
        self._stop = threading.Event()
        self._thread = None
        self._recorder = recorder
        self._fired_at_stamp = None  # heartbeat value already reported
        self.fired: list[dict] = []
        self._m_fires = _fires_counter()

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, name="paddle-serving-watchdog",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        return self

    def _busy(self):
        e = self.engine
        try:
            return bool(e._queue) or any(s is not None for s in e._slots)
        except Exception:
            return False

    def _monitor(self):
        while not self._stop.wait(self.poll_s):
            e = self.engine
            stamp = getattr(e, "_progress_t", None)
            if stamp is None or not getattr(e, "_started", False):
                continue
            if _programs.ledger().compiling(e):
                # the program ledger holds an OPEN compile window for this
                # engine: a first dispatch building its kernels (nvcc),
                # running and capturing its program — slow, not stuck.
                # The ledger (not an engine flag someone forgot to clear)
                # is the authority, and its compile_in_progress gauge keeps
                # the stall visible on /statusz while we stay quiet.
                continue
            age = monotonic() - stamp
            if age <= self.deadline_s or not self._busy():
                if stamp != self._fired_at_stamp:
                    self._fired_at_stamp = None  # progress resumed: re-arm
                continue
            if self._fired_at_stamp == stamp:
                continue  # already reported this wedge
            self._fired_at_stamp = stamp
            self._fire(age)

    def _fire(self, age):
        e = self.engine
        try:
            stats = e.stats()
        except Exception:
            stats = {}
        record = {"age_s": age,
                  "iteration": getattr(e, "_iteration", None),
                  "stats": stats}
        logger.error(
            "SERVING WATCHDOG: scheduler thread made no progress for %.1fs "
            "(deadline %.1fs) with work pending — iteration=%s queue=%s "
            "active=%s; dumping flight record", age, self.deadline_s,
            record["iteration"], stats.get("queue_depth"),
            stats.get("active_slots"))
        rec = self._recorder or _flight.get_flight_recorder()
        rec.record("watchdog", "serving_scheduler_wedge", **record)
        record["dump_path"] = rec.dump("serving_watchdog", extra=record)
        self._m_fires.inc(kind="serving", op="scheduler_wedge")
        self.fired.append(record)
        _notify_fire("serving", record)
