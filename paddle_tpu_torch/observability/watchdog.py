"""Watchdog over a wedged serving scheduler (counterpart of
``paddle_tpu/observability/watchdog.py``, its :class:`ServingWatchdog`;
the flight-recorder dump and the fire counter wait for the metrics
registry and the flight recorder).

:class:`ServingWatchdog` monitors one :class:`ServingEngine`: if work is
pending (queued requests or occupied slots) and the scheduler loop's
heartbeat (``engine._progress_t``, stamped once per iteration and after
every dispatch) has not advanced within the deadline, the scheduler is
wedged: the watchdog logs it loudly and appends a record to
:attr:`ServingWatchdog.fired`, once per wedge, re-arming when progress
resumes.  It stays quiet while the engine's first dispatch builds a
kernel (``engine._compiling``): slow, not stuck.

The engine starts one when it is given ``watchdog_s``.
"""

from __future__ import annotations

import logging
import threading
from time import monotonic

logger = logging.getLogger("paddle_tpu_torch.observability")


class ServingWatchdog:
    """Wedged-scheduler detector for one :class:`ServingEngine`.

    Fires when the engine has pending work but its heartbeat is older
    than the deadline.  Re-arms after progress resumes, so a second wedge
    fires again."""

    def __init__(self, engine, deadline_s, poll_s=None):
        self.engine = engine
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(min(self.deadline_s / 4, 5.0), 0.02)
        self._stop = threading.Event()
        self._thread = None
        self._fired_at_stamp = None  # heartbeat value already reported
        self.fired: list[dict] = []

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
            if getattr(e, "_compiling", False):
                # a dispatch is building a kernel (nvcc on first use):
                # slow, not stuck
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
            "active=%s", age, self.deadline_s, record["iteration"],
            stats.get("queue_depth"), stats.get("active_slots"))
        self.fired.append(record)
