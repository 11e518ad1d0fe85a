"""Emergency checkpointing: save state the moment the process learns it is
dying or wedged (counterpart of ``paddle_tpu/resilience/emergency.py``).

Two triggers, both landing in :meth:`AsyncCheckpointManager.save_emergency`
(synchronous, bypassing the writer queue, never raising):

- **SIGTERM** (preemption notice) — a chained handler in the style of the
  flight recorder's crash handlers: save, then re-deliver to the previous
  disposition so the process still dies with the right signal;
- **watchdog fires** — :mod:`paddle_tpu_torch.observability.watchdog`
  notifies registered fire listeners when the serving scheduler exceeds
  its deadline; a hung job's last good state gets persisted while the
  flight recorder captures the forensics.

``arm_emergency_checkpoint(manager, state_fn)`` wires both and returns a
``disarm()`` callable.  ``state_fn() -> (step, state)`` is called at
trigger time, so it must be cheap.  A Python signal handler runs on the
main thread between bytecodes, so state on the card is copied off it
there by the snapshot's synchronous copy (a handler that lands while
the main thread waits in a CUDA call runs once that call returns).
"""

from __future__ import annotations

import logging
import os
import signal as _signal
import threading

from ..profiler import metrics as _metrics

logger = logging.getLogger("paddle_tpu_torch.resilience")


def _saves_counter():
    return _metrics.counter("resilience.emergency_saves",
                            "emergency checkpoints by trigger")


def arm_emergency_checkpoint(manager, state_fn, signals=("SIGTERM",),
                             on_watchdog=True):
    """Arm emergency checkpointing.  Returns ``disarm()``.

    ``signals`` chain handlers (main thread only — from a worker thread the
    signal leg is skipped, matching the flight recorder's contract);
    ``on_watchdog`` registers a watchdog fire listener.  Each trigger saves
    at most once per (trigger, step): a watchdog re-firing on the same
    wedge doesn't rewrite the same checkpoint forever."""
    from ..observability import watchdog as _watchdog

    m_saves = _saves_counter()
    seen: set = set()
    lock = threading.Lock()
    disarmed = threading.Event()

    def save(trigger, from_signal=False):
        if disarmed.is_set():
            return None
        try:
            step, state = state_fn()
        except Exception:
            if not from_signal:  # logging locks are off-limits in a handler
                logger.exception("emergency state_fn failed (trigger=%s)",
                                 trigger)
            return None
        # signal-path discipline (the flight recorder's rule): this may
        # run INSIDE a signal handler on the main thread, where blocking on
        # a lock the interrupted frame holds would deadlock the dying
        # process.  Non-blocking: a nested re-delivered signal (or a
        # concurrent watchdog fire) just skips — the holder is already
        # saving.
        if not lock.acquire(blocking=False):
            return None
        try:
            key = (trigger, int(step))
            if key in seen:
                return None
            seen.add(key)
        finally:
            lock.release()
        path = manager.save_emergency(step, state, reason=trigger,
                                      from_signal=from_signal)
        if path is not None and not from_signal:
            # metric + logging locks only OFF the signal path — the
            # interrupted frame may hold either
            m_saves.inc(trigger=trigger)
            logger.error("emergency checkpoint (trigger=%s) committed: %s",
                         trigger, path)
        return path

    listener = None
    if on_watchdog:
        def listener(kind, record):  # noqa: F811 — the armed closure
            save(f"watchdog_{kind}")

        _watchdog.add_fire_listener(listener)

    installed = []
    if threading.current_thread() is threading.main_thread():
        for name in signals:
            sig = getattr(_signal, name, None)
            if sig is None:
                continue
            try:
                prev = _signal.getsignal(sig)

                def _handler(signum, frame, _prev=prev):
                    save(f"signal_{_signal.Signals(signum).name}",
                         from_signal=True)
                    if _prev == _signal.SIG_IGN:
                        return
                    if callable(_prev) and _prev != _signal.SIG_DFL:
                        _prev(signum, frame)
                    else:
                        _signal.signal(signum, _signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

                _signal.signal(sig, _handler)
                installed.append((sig, prev))
            except (ValueError, OSError):
                pass
    elif signals:
        logger.warning(
            "arm_emergency_checkpoint called off the main thread: signal "
            "handlers skipped (watchdog trigger still armed)")

    def disarm():
        disarmed.set()
        if listener is not None:
            _watchdog.remove_fire_listener(listener)
        for sig, prev in installed:
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    return disarm
