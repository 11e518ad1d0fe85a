"""Host-side event tree for the profiler (counterpart of
``paddle_tpu/profiler/events.py``).

A thread-local stack of :class:`HostEvent` nodes collects named, timed
host regions in-process.  Instrumented call sites check the module-level
``_ACTIVE`` flag — a single attribute load — so a run without an active
collector pays one ``if`` and nothing else.

Timing is host wall-clock.  PyTorch launches CUDA work asynchronously, so
around a kernel call that is time-to-enqueue, not device time; the device
timeline comes from a ``torch.profiler`` trace, where
:class:`RecordEvent` regions show up through
``torch.profiler.record_function``.
"""

from __future__ import annotations

import threading
from time import perf_counter

import torch

# Fast-path flag: instrumented call sites read this directly.  It is True
# exactly while a collector is started.
_ACTIVE = False
_LOCK = threading.Lock()
_COLLECTOR = None  # the single active EventCollector, if any


class HostEvent:
    """One timed region: name, [t0, t1), nested children."""

    __slots__ = ("name", "t0", "t1", "tid", "children")

    def __init__(self, name, t0, tid=0):
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.tid = tid
        self.children = []

    @property
    def duration(self):
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def self_time(self):
        return max(self.duration - sum(c.duration for c in self.children), 0.0)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):
        return (f"HostEvent({self.name!r}, {self.duration * 1e3:.3f} ms, "
                f"{len(self.children)} children)")


class EventCollector:
    """Collects a forest of HostEvents, one stack per thread."""

    def __init__(self):
        self.roots: list[HostEvent] = []
        self._tls = threading.local()

    # ------------------------------------------------------------- control
    def start(self):
        global _ACTIVE, _COLLECTOR
        with _LOCK:
            _COLLECTOR = self
            _ACTIVE = True
        return self

    def stop(self):
        global _ACTIVE, _COLLECTOR
        with _LOCK:
            if _COLLECTOR is self:
                _COLLECTOR = None
                _ACTIVE = False
        return self

    # ----------------------------------------------------------- recording
    def _stack(self):
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def push(self, name):
        ev = HostEvent(name, perf_counter(), tid=threading.get_ident())
        stack = self._stack()
        if stack:
            stack[-1].children.append(ev)
        else:
            with _LOCK:
                self.roots.append(ev)
        stack.append(ev)
        return ev

    def pop(self, ev):
        ev.t1 = perf_counter()
        stack = self._stack()
        if stack and stack[-1] is ev:
            stack.pop()

    def add_complete(self, name, t0, t1):
        """Record an already-timed leaf (dispatch fast path: no context
        manager, two perf_counter() calls at the call site)."""
        ev = HostEvent(name, t0, tid=threading.get_ident())
        ev.t1 = t1
        stack = self._stack()
        if stack:
            stack[-1].children.append(ev)
        else:
            with _LOCK:
                self.roots.append(ev)
        return ev

    # ---------------------------------------------------------- summaries
    def all_events(self):
        for r in list(self.roots):
            yield from r.walk()

    def op_summary(self):
        """name -> dict(calls, total, max) over every event in the forest.

        ``total`` sums each event's own duration; nested same-name events
        (a Layer calling sub-Layers) therefore overlap, exactly like the
        reference's op-summary semantics.
        """
        return aggregate_durations(
            (ev.name, ev.duration) for ev in self.all_events()
            if ev.t1 is not None)


def aggregate_durations(pairs):
    """(name, seconds) pairs -> {name: {calls, total, max}} — the
    op-summary fold of :meth:`EventCollector.op_summary`."""
    agg: dict[str, dict] = {}
    for name, dur in pairs:
        d = agg.setdefault(name, {"calls": 0, "total": 0.0, "max": 0.0})
        d["calls"] += 1
        d["total"] += dur
        d["max"] = max(d["max"], dur)
    return agg


def active_collector():
    return _COLLECTOR


def add_complete(name, t0, t1):
    """Module-level fast path used by instrumented call sites (they check
    ``_ACTIVE`` themselves before timing)."""
    c = _COLLECTOR
    if c is not None:
        c.add_complete(name, t0, t1)


class record:
    """Minimal host-only region recorder (no trace annotation)."""

    __slots__ = ("name", "_ev", "_col")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._col = _COLLECTOR
        self._ev = self._col.push(self.name) if self._col is not None else None
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            self._col.pop(self._ev)


class RecordEvent:
    """reference: paddle.profiler.RecordEvent — names a user region.

    Feeds BOTH sinks: the host event tree (when a collector is active, for
    the in-process summary tables) and ``torch.profiler.record_function``
    (a labelled range in a ``torch.profiler`` trace, beside the kernels
    it launched).  Usable as a context manager or via explicit
    begin()/end().
    """

    def __init__(self, name, event_type=None):
        self.name = name
        self.event_type = event_type
        self._ev = None
        self._col = None
        self._ann = None

    def begin(self):
        if _ACTIVE:
            self._col = _COLLECTOR
            if self._col is not None:
                self._ev = self._col.push(self.name)
        try:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        except Exception:
            self._ann = None
        return self

    def end(self):
        if self._ann is not None:
            try:
                self._ann.__exit__(None, None, None)
            except Exception:
                pass
            self._ann = None
        if self._ev is not None and self._col is not None:
            self._col.pop(self._ev)
            self._ev = None

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
