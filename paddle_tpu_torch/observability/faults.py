"""Fault injection: hooks for the resilience tests and seeded,
deterministic fault *plans* (counterpart of
``paddle_tpu/observability/faults.py``, a copy of it; this package keeps
its own registry, so arming a site here never trips the reference's).

Instrumented sites call :func:`maybe` with their site name; when a
matching fault is armed the site hangs there (a sleep that releases early
when the fault is cleared) and/or runs an injected callable (which may
raise — that is how a test turns a real code path into a crash).
Disarmed, :func:`maybe` is one module-flag check.

Arming spellings:

- :func:`inject` — one fault, with ``seconds`` / ``fn`` / ``times`` and
  *scheduled* (``at_trips={3}``, ``every=5``) or *probabilistic*
  (``probability=0.2, seed=7`` — a seeded rng, deterministic replay)
  firing;
- :class:`FaultPlan` — a reusable, seeded set of faults with scoped
  arming (``with plan: ...`` guarantees disarm).

Sites wired in this package:

- ``serving.scheduler_wedge`` — top of the serving scheduler loop, after
  the heartbeat (:meth:`~..serving.engine.ServingEngine._loop`);
- ``serving.step_crash`` — immediately before the batched decode (or
  verify) dispatch (:meth:`~..serving.engine.ServingEngine._step_once`);
- ``numerics.nan_inject`` — each trip turns the next
  :func:`~.numerics.consume_nan_inject` call into a NaN that a guarded
  serving dispatch adds to one lane's logits;
- ``memory.leak`` — each trip grows the memory ledger's synthetic
  ``fault.memory_leak`` owner (:class:`~.memory.MemoryWatchdog`);
- every engine also polls ``serving.scheduler_wedge@<replica>`` and
  ``serving.step_crash@<replica>``.
"""

from __future__ import annotations

import random
import threading
from time import monotonic, sleep

_ARMED = False  # fast-path flag, mirrors bool(_FAULTS)
_FAULTS: dict[str, dict] = {}
# specs popped by times=/schedule exhaustion whose sleep may still be in
# flight — clear() must be able to cancel these too (one entry per name)
_EXHAUSTED: dict[str, dict] = {}
_LOCK = threading.Lock()


def inject(name, seconds=None, fn=None, times=None, probability=None,
           at_trips=None, every=None, seed=None):
    """Arm fault ``name``: a hang of ``seconds`` (released early by
    :func:`clear`) and/or a callable ``fn`` (exceptions propagate into the
    instrumented site — injected crashes are real crashes).

    Firing discipline (evaluated per :func:`maybe` call, in order):

    - ``at_trips``: fire only on these 1-based call numbers (a *schedule*;
      self-disarms once the last scheduled call has passed);
    - ``every``: fire on every Nth call;
    - ``probability``: additionally gate each firing on a seeded rng draw
      (``seed`` defaults to a stable hash of the site name, so replays are
      deterministic without ceremony);
    - ``times``: total firings before self-disarm (None = until cleared).
    """
    global _ARMED
    if at_trips is not None:
        at_trips = frozenset(int(t) for t in at_trips)
        if not at_trips or min(at_trips) < 1:
            raise ValueError("at_trips must be 1-based call numbers")
    rng = None
    if probability is not None:
        if seed is None:
            from ..resilience.retry import derive_seed

            seed = derive_seed("fault", name)
        rng = random.Random(seed)
    with _LOCK:
        _FAULTS[name] = {"seconds": seconds, "fn": fn, "times": times,
                         "probability": probability, "at_trips": at_trips,
                         "every": int(every) if every else None, "rng": rng,
                         "calls": 0, "trips": 0, "cancelled": False}
        _ARMED = True


def clear(name=None):
    """Disarm one fault (or all).  A site currently hanging in it wakes up
    within one poll tick."""
    global _ARMED
    with _LOCK:
        if name is None:
            for spec in _FAULTS.values():
                spec["cancelled"] = True
            for spec in _EXHAUSTED.values():
                spec["cancelled"] = True
            _FAULTS.clear()
            _EXHAUSTED.clear()
        else:
            for spec in (_FAULTS.pop(name, None),
                         _EXHAUSTED.pop(name, None)):
                if spec is not None:
                    spec["cancelled"] = True
        _ARMED = bool(_FAULTS)


def armed(name) -> bool:
    return name in _FAULTS


def trip_count(name) -> int:
    spec = _FAULTS.get(name) or _EXHAUSTED.get(name)
    return spec["trips"] if spec else 0


def describe() -> list:
    """Currently-armed faults as JSON-able rows."""
    with _LOCK:
        return [{"site": name, "calls": s["calls"], "trips": s["trips"],
                 "seconds": s["seconds"], "times": s["times"],
                 "probability": s["probability"],
                 "at_trips": sorted(s["at_trips"]) if s["at_trips"] else None,
                 "every": s["every"], "fn": s["fn"] is not None}
                for name, s in _FAULTS.items()]


def maybe(name):
    """Trip fault ``name`` if armed and its schedule/probability says fire
    (called by instrumented sites)."""
    global _ARMED
    if not _ARMED:
        return
    with _LOCK:
        spec = _FAULTS.get(name)
        if spec is None:
            return
        spec["calls"] += 1
        if spec["at_trips"] is not None:
            fire = spec["calls"] in spec["at_trips"]
        elif spec["every"]:
            fire = spec["calls"] % spec["every"] == 0
        else:
            fire = True
        if fire and spec["probability"] is not None:
            fire = spec["rng"].random() < spec["probability"]
        exhausted = (spec["at_trips"] is not None
                     and spec["calls"] >= max(spec["at_trips"]))
        if fire:
            spec["trips"] += 1
            if spec["times"] is not None and spec["trips"] >= spec["times"]:
                exhausted = True
        if exhausted:
            _FAULTS.pop(name, None)
            _EXHAUSTED[name] = spec  # clear() can still cancel the sleep
            _ARMED = bool(_FAULTS)
        if not fire:
            return
    if spec["fn"] is not None:
        spec["fn"]()
    if spec["seconds"]:
        end = monotonic() + float(spec["seconds"])
        # poll so clear() releases a hanging site promptly
        while monotonic() < end and not spec["cancelled"]:
            sleep(0.01)


class FaultPlan:
    """A seeded, reusable set of faults with scoped arming.

    .. code-block:: python

        plan = (FaultPlan(seed=7)
                .add("serving.step_crash", fn=boom, at_trips={3})
                .add("collective_hang", seconds=0.5, probability=0.1))
        with plan:          # arm on enter, disarm (and wake hangs) on exit
            run_workload()
        plan.describe()     # what was armed + how often each site tripped

    Determinism: each entry's probabilistic rng is seeded from
    ``(plan seed, entry index, site)``, so the same plan over the same
    workload trips at the same calls — a failing chaos run replays
    exactly.  One entry per site (a later ``add`` for the same site
    overrides the earlier one at arm time, matching :func:`inject`).
    """

    def __init__(self, seed=0):
        self.seed = int(seed)
        self._entries: list[dict] = []

    def add(self, site, seconds=None, fn=None, times=None, probability=None,
            at_trips=None, every=None):
        self._entries.append({
            "site": site, "seconds": seconds, "fn": fn, "times": times,
            "probability": probability, "at_trips": at_trips, "every": every,
        })
        return self

    @property
    def sites(self):
        return [e["site"] for e in self._entries]

    def arm(self):
        from ..resilience.retry import derive_seed

        for i, e in enumerate(self._entries):
            e["_trips"] = 0  # fresh cycle: drop the previous run's snapshot
            inject(e["site"], seconds=e["seconds"], fn=e["fn"],
                   times=e["times"], probability=e["probability"],
                   at_trips=e["at_trips"], every=e["every"],
                   seed=derive_seed(self.seed, i, e["site"]))
        return self

    def disarm(self):
        for e in self._entries:
            # snapshot the trip count BEFORE clear() drops the spec, so
            # describe() after the with-block still reports how often
            # each site fired (the documented post-run usage)
            e["_trips"] = trip_count(e["site"])
            clear(e["site"])

    def __enter__(self):
        return self.arm()

    def __exit__(self, *exc):
        self.disarm()

    def describe(self):
        armed_sites = {row["site"] for row in describe()}
        # trip_count covers armed AND schedule-exhausted sites; once clear()
        # dropped the spec it reads 0 and the disarm-time snapshot answers
        return [{"site": e["site"], "seconds": e["seconds"],
                 "times": e["times"], "probability": e["probability"],
                 "at_trips": sorted(e["at_trips"]) if e["at_trips"] else None,
                 "every": e["every"], "fn": e["fn"] is not None,
                 "armed": e["site"] in armed_sites,
                 "trips": trip_count(e["site"]) or e.get("_trips", 0)}
                for e in self._entries]
