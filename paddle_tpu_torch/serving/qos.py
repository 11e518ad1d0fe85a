"""QoS-tiered serving: priority tiers, weighted admission, deliberate
preemption and SLO-aware brownouts (counterpart of
``paddle_tpu/serving/qos.py``).

Production traffic is not one class: an interactive ``realtime``
request, a ``standard`` API call and a ``batch`` eval row have different
latency promises, and under pressure the engine must degrade the cheap
promises first.  This module is the policy half:

- :class:`TierPolicy` / :class:`QoSConfig` — the tier table: priority
  (admission order AND preemption rank), weighted-round-robin admission
  weight, an optional per-tier :class:`~..observability.slo.SLOPolicy`,
  the burn-rate threshold past which the tier is shed (brownout), a
  per-tier queue bound, and whether running requests of the tier may be
  preempted;
- :class:`TieredQueue` — per-tier deques behind the engine's ``deque``
  surface (``append`` / ``appendleft`` / ``popleft`` / ``[0]`` / ``len``),
  so every scheduler call site works unchanged while head selection
  becomes priority-ordered weighted round robin (credits refill per
  cycle: with weights 8/3/1 a saturated engine admits 8 realtime, 3
  standard, 1 batch per cycle — bounded starvation, not strict priority);
- :func:`brownout` — the shed ladder: the protected (highest-priority)
  tier's SLO burn rate decides which lower tiers shed at admission
  (level 1 sheds ``batch``, level 2 also ``standard``, level 3 = the
  engine is actively preempting), surfaced in ``health_state()``.

- :class:`AutoScaler` — the elastic replica count of a cluster's
  :class:`~.cluster.pool.ReplicaPool`: scale up under queue, occupancy or
  burn pressure, drain-then-retire when idle, reap and replace lost
  replicas, with hysteresis and a cooldown.

The mechanism half — eviction, requeue as prompt + tokens-so-far with
the remaining budget — is the engine's restart-recovery requeue
scheduled on purpose, so a preempted greedy request's final ids are the
ones an uninterrupted run gives.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from ..observability.slo import SLOPolicy
from ..profiler import metrics as _metrics

#: brownout rung names for the default three-tier ladder (index = level)
BROWNOUT_LADDER = ("normal", "shed_batch", "shed_standard", "preempt")


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """One tier's policy.  ``priority`` orders admission and preemption
    (higher = more important — a request preempts only strictly-lower
    tiers); ``weight`` is the tier's credits per weighted-round-robin
    admission cycle; ``slo`` accounts the tier's own attainment/burn
    (``serving.slo.*{tier=}``); ``shed_burn_rate`` is the PROTECTED
    tier's burn rate past which THIS tier sheds at admission (None =
    never brownout-shed — the protected tier itself); ``max_queue``
    bounds the tier's queue (None = unbounded); ``preemptible=False``
    exempts running requests of the tier from QoS eviction."""

    name: str
    priority: int
    weight: int = 1
    slo: SLOPolicy | None = None
    shed_burn_rate: float | None = None
    max_queue: int | None = None
    preemptible: bool = True

    def __post_init__(self):
        if not self.name:
            raise ValueError("tier name must be non-empty")
        if self.weight < 1:
            raise ValueError(
                f"tier {self.name!r}: weight must be >= 1, got {self.weight}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"tier {self.name!r}: max_queue must be >= 1 or None")


class QoSConfig:
    """The engine's tier table.  ``tiers`` is an iterable of
    :class:`TierPolicy` (unique names); ``default_tier`` serves
    ``submit(tier=None)``; ``preempt_burn_rate`` is the protected-tier
    burn past which the brownout ladder reports its top rung even before
    demand-driven preemption fires.  Immutable after construction — one
    config is safely shared by every replica of a pool (per-engine
    mutable state lives in :class:`TieredQueue`)."""

    def __init__(self, tiers=None, default_tier=None, preempt_burn_rate=8.0):
        tiers = tuple(tiers) if tiers is not None else self._default_tiers()
        if not tiers:
            raise ValueError("need at least one TierPolicy")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        if len({t.priority for t in tiers}) != len(tiers):
            raise ValueError("tier priorities must be distinct")
        # priority-descending: index 0 is the protected tier
        self.tiers = tuple(sorted(tiers, key=lambda t: -t.priority))
        self._by_name = {t.name: t for t in self.tiers}
        self.default_tier = default_tier if default_tier is not None \
            else self.tiers[len(self.tiers) // 2].name
        if self.default_tier not in self._by_name:
            raise ValueError(f"default_tier {self.default_tier!r} not in "
                             f"{sorted(self._by_name)}")
        self.preempt_burn_rate = float(preempt_burn_rate)

    @staticmethod
    def _default_tiers():
        """The documented three-tier ladder.  ``realtime`` is protected
        (never brownout-shed, never preempted); ``standard`` sheds when
        realtime burns its error budget 4x too fast, ``batch`` at 2x."""
        return (
            TierPolicy("realtime", priority=2, weight=8, preemptible=False),
            TierPolicy("standard", priority=1, weight=3, shed_burn_rate=4.0),
            TierPolicy("batch", priority=0, weight=1, shed_burn_rate=2.0),
        )

    @property
    def names(self):
        return tuple(t.name for t in self.tiers)

    @property
    def protected(self) -> TierPolicy:
        """The highest-priority tier — whose SLO burn drives the ladder."""
        return self.tiers[0]

    def tier(self, name) -> TierPolicy:
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(f"unknown tier {name!r}; configured tiers: "
                             f"{list(self.names)}") from None

    def resolve(self, name):
        """Submit-time tier resolution: ``None`` → the default tier;
        unknown names rejected loudly."""
        if name is None:
            return self.default_tier
        return self.tier(name).name

    def shed_tiers(self, burn_rate):
        """Tiers that shed at admission when the protected tier's burn
        rate is ``burn_rate`` (priority-ascending: batch sheds first)."""
        if burn_rate is None:
            return ()
        return tuple(t.name for t in reversed(self.tiers)
                     if t.shed_burn_rate is not None
                     and burn_rate >= t.shed_burn_rate)

    def to_dict(self):
        return {
            "default_tier": self.default_tier,
            "preempt_burn_rate": self.preempt_burn_rate,
            "tiers": [{
                "name": t.name, "priority": t.priority, "weight": t.weight,
                "preemptible": t.preemptible, "max_queue": t.max_queue,
                "shed_burn_rate": t.shed_burn_rate,
                "slo": t.slo.to_dict() if t.slo is not None else None,
            } for t in self.tiers],
        }


def brownout(config: QoSConfig, burn_rate, preempting=False):
    """The brownout ladder as a JSON-able dict: ``level`` (0 = normal,
    each shed tier adds a rung, preemption is the top rung), ``state``
    (the rung name for the default ladder, generic otherwise), ``shed``
    (tier names currently shed at admission) and the driving
    ``burn_rate``.  ``preempting=True`` — the engine evicted a slot
    recently — forces the top rung regardless of burn."""
    b = float(burn_rate) if burn_rate is not None else 0.0
    shed = config.shed_tiers(b)
    top = len(config.tiers)  # one rung past every sheddable tier
    level = len(shed)
    if preempting or b >= config.preempt_burn_rate:
        level = top
    if level == 0:
        state = "normal"
    elif level >= top:
        state = "preempt"
    else:
        state = f"shed_{shed[-1]}" if len(config.tiers) == 3 else "shed"
    return {"level": level, "state": state, "shed": list(shed),
            "burn_rate": b}


class TieredQueue:
    """Per-tier deques behind the engine's single-deque surface.

    Head selection (``[0]`` / ``popleft``) is priority-ordered weighted
    round robin: each tier holds ``weight`` credits; the head is the
    highest-priority non-empty tier with credit left, and when every
    non-empty tier is out of credits the cycle refills all of them.
    Selection is a pure function of (queues, credits), so a ``[0]`` peek
    and the ``popleft`` that follows it under the scheduler lock agree.
    ``append`` routes by ``req.tier``; ``appendleft`` — the restart /
    preemption requeue path — puts the request at the FRONT of its
    tier's deque so resumed work runs before new same-tier arrivals.
    NOT thread-safe: callers hold the engine lock, same as the plain
    deque it replaces.
    """

    def __init__(self, config: QoSConfig):
        self.config = config
        self._qs = {t.name: collections.deque() for t in config.tiers}
        self._credits = {t.name: t.weight for t in config.tiers}
        self._order = config.names  # priority-descending

    # ------------------------------------------------------- deque surface
    def __len__(self):
        return sum(len(q) for q in self._qs.values())

    def __bool__(self):
        return any(self._qs.values())

    def _head_tier(self):
        avail = [n for n in self._order if self._qs[n]]
        if not avail:
            return None
        with_credit = [n for n in avail if self._credits[n] > 0]
        # no non-empty tier has credit: the refill (done by popleft)
        # gives everyone credit, so the choice is the top-priority tier
        return (with_credit or avail)[0]

    def __getitem__(self, i):
        if i != 0:
            raise IndexError("TieredQueue only exposes the head ([0])")
        t = self._head_tier()
        if t is None:
            raise IndexError("peek from an empty TieredQueue")
        return self._qs[t][0]

    def popleft(self):
        t = self._head_tier()
        if t is None:
            raise IndexError("pop from an empty TieredQueue")
        if self._credits[t] <= 0:  # cycle exhausted: refill everyone
            for name in self._order:
                self._credits[name] = self.config.tier(name).weight
        self._credits[t] -= 1
        return self._qs[t].popleft()

    def pop_exact(self, req):
        """Pop ``req`` — known to be at the head of its tier's deque —
        applying the same credit accounting as :meth:`popleft`.  The
        scheduler peeks ``[0]``, may PREEMPT (which appendlefts victims
        into lower-priority tiers), then pops; popping by identity
        instead of re-running head selection makes that sequence immune
        to any future change in how the head is chosen."""
        t = req.tier
        q = self._qs[t]
        if not q or q[0] is not req:
            raise ValueError(
                f"pop_exact: request is not at the head of tier {t!r}")
        if self._credits[t] <= 0:
            for name in self._order:
                self._credits[name] = self.config.tier(name).weight
        self._credits[t] -= 1
        return q.popleft()

    def append(self, req):
        self._qs[req.tier].append(req)

    def appendleft(self, req):
        self._qs[req.tier].appendleft(req)

    # ------------------------------------------------------------- insight
    def depth(self, tier):
        return len(self._qs[tier])

    def depths(self):
        return {name: len(q) for name, q in self._qs.items()}

    def depth_at_or_above(self, priority):
        """Queued requests whose tier priority is >= ``priority`` — the
        queue-position population a deadline estimate for that tier
        competes with (lower tiers never delay it past one cycle)."""
        return sum(len(self._qs[t.name]) for t in self.config.tiers
                   if t.priority >= priority)


class AutoScaler:
    """Elastic replica count for a :class:`~.cluster.pool.ReplicaPool`.

    Driven by explicit :meth:`tick` calls (the
    :class:`~.cluster.service.ServingCluster` monitor thread calls it
    every poll; ``interval_s`` throttles the actual evaluation).  Scale
    decisions need their signal to hold continuously for ``stable_s``
    (hysteresis) and respect ``cooldown_s`` between events, so a traffic
    blip neither thrashes the fleet up nor collapses it mid-burst.

    - **up**: queued-per-replica >= ``scale_up_queue``, or fleet
      occupancy >= ``scale_up_occupancy``, or the protected tier's SLO
      burn (``burn_source()``) >= ``scale_up_burn_rate`` — and the pool
      is below ``max_replicas``.  Spin-up is warm: the pool replays its
      ``warmup=`` manifest before the new replica's scheduler starts.
    - **down**: empty queues and occupancy <= ``scale_down_occupancy``
      above ``min_replicas`` → the newest replica stops ADMITTING
      (``begin_drain``) and is stopped + removed only once quiescent —
      drain-then-retire, no in-flight request dropped.
    - **reap**: a replica whose health reads ``error``/``stopped`` (fatal
      crash, ``cluster.replica_preempt@<r>``) is removed immediately and
      replaced up to ``min_replicas`` without waiting out the cooldown —
      replacing lost capacity is not a scale decision.

    ``history`` records ``{"t", "replicas", "event"}`` rows (the bench's
    replica-count timeline); ``cluster.replicas{state=}`` and
    ``cluster.scale_events{direction=up|down|reap}`` export the same.
    """

    #: health states counted as serving capacity
    _LIVE = ("healthy", "degraded")
    _DEAD = ("error", "stopped")

    def __init__(self, pool, min_replicas=1, max_replicas=4,
                 scale_up_queue=4.0, scale_up_occupancy=0.85,
                 scale_up_burn_rate=2.0, scale_down_occupancy=0.25,
                 stable_s=2.0, cooldown_s=5.0, interval_s=0.25,
                 burn_source=None, cluster="0"):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < min_replicas "
                             f"{min_replicas}")
        self.pool = pool
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_queue = float(scale_up_queue)
        self.scale_up_occupancy = float(scale_up_occupancy)
        self.scale_up_burn_rate = None if scale_up_burn_rate is None \
            else float(scale_up_burn_rate)
        self.scale_down_occupancy = float(scale_down_occupancy)
        self.stable_s = float(stable_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self._burn_source = burn_source
        self.history = []                 # [{"t","replicas","event"}]
        self._lock = threading.Lock()
        self._retiring = None             # engine draining toward removal
        self._up_since = None             # hysteresis: signal onset stamps
        self._down_since = None
        self._last_event_t = None
        self._last_tick_t = None
        self._m_replicas = _metrics.bind(
            _metrics.gauge("cluster.replicas",
                           "pool replicas by health state"),
            cluster=str(cluster))
        self._m_events = _metrics.bind(
            _metrics.counter("cluster.scale_events",
                             "autoscaler actions by direction=up|down|reap"),
            cluster=str(cluster))

    # -------------------------------------------------------------- insight
    @property
    def retiring(self):
        return self._retiring

    def timeline(self):
        with self._lock:
            return list(self.history)

    def _record(self, event, n, now):
        self.history.append({"t": now, "replicas": n, "event": event})

    # ----------------------------------------------------------------- tick
    def tick(self, now=None):
        """Evaluate signals and maybe scale; returns the event applied
        this tick (``"up"`` / ``"down"`` / ``"reap"`` / None).  Safe to
        call from any single thread at any rate — evaluation is
        throttled to ``interval_s``."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if self._last_tick_t is not None \
                    and now - self._last_tick_t < self.interval_s:
                return None
            self._last_tick_t = now
            return self._tick_locked(now)

    def _tick_locked(self, now):
        event = None
        engines, states = self.pool.snapshot_states()
        # 1. finish an in-progress retirement (drain-then-retire)
        ret = self._retiring
        if ret is not None:
            hs = ret.health_state()["state"]
            if hs in self._DEAD or ret.quiescent:
                self._stop_quietly(ret)
                self.pool.remove_replica(ret)
                self._retiring = None
                self._last_event_t = now
                event = "down"
                self._m_events.inc(direction="down")
                engines, states = self.pool.snapshot_states()
                self._record("down", len(engines), now)
        # 2. reap dead replicas (fatal crash / injected replica loss) and
        #    replace lost capacity up to min_replicas — no cooldown: this
        #    restores promised capacity, it doesn't change the target
        dead = [e for e, st in zip(engines, states)
                if st["state"] in self._DEAD and e is not self._retiring]
        for e in dead:
            self._stop_quietly(e)
            self.pool.remove_replica(e)
            self._m_events.inc(direction="reap")
            event = event or "reap"
        if dead:
            engines, states = self.pool.snapshot_states()
            self._record("reap", len(engines), now)
        while len(engines) < self.min_replicas:
            self.pool.add_replica()
            self._m_events.inc(direction="up")
            engines, states = self.pool.snapshot_states()
            self._record("up", len(engines), now)
            event = event or "up"
        self._export_gauges(states)
        if self._retiring is not None:
            return event            # one state change in flight at a time
        # 3. signals over the live fleet
        live = [st for st in states if st["state"] in self._LIVE]
        n = len(live)
        if n == 0:
            return event
        queued = sum(st["queue_depth"] for st in live)
        slots = sum(st["num_slots"] for st in live) or 1
        occupancy = sum(st["active"] for st in live) / slots
        burn = None
        if self._burn_source is not None:
            try:
                burn = self._burn_source()
            except Exception:
                burn = None
        up = len(engines) < self.max_replicas and (
            queued / n >= self.scale_up_queue
            or occupancy >= self.scale_up_occupancy
            or (burn is not None and self.scale_up_burn_rate is not None
                and burn >= self.scale_up_burn_rate))
        down = (len(engines) > self.min_replicas and queued == 0
                and occupancy <= self.scale_down_occupancy)
        # hysteresis: the signal must hold since onset for stable_s
        # (explicit None checks — an onset stamp of 0.0 is a valid time)
        self._up_since = None if not up else (
            self._up_since if self._up_since is not None else now)
        self._down_since = None if not down else (
            self._down_since if self._down_since is not None else now)
        in_cooldown = (self._last_event_t is not None
                       and now - self._last_event_t < self.cooldown_s)
        if up and now - self._up_since >= self.stable_s and not in_cooldown:
            self.pool.add_replica()
            self._up_since = None
            self._last_event_t = now
            self._m_events.inc(direction="up")
            engines, states = self.pool.snapshot_states()
            self._export_gauges(states)
            self._record("up", len(engines), now)
            return "up"
        if down and now - self._down_since >= self.stable_s \
                and not in_cooldown:
            victim = engines[-1]          # newest replica retires first
            victim.begin_drain()
            self._retiring = victim
            self._down_since = None
            self._record("drain", len(engines), now)
            return event
        return event

    @staticmethod
    def _stop_quietly(engine):
        try:
            engine.stop()
        except Exception:
            pass                          # a dead engine may refuse; reap on

    def _export_gauges(self, states):
        counts = {s: 0 for s in
                  ("healthy", "degraded", "draining", "stopped", "error")}
        for st in states:
            counts[st["state"]] = counts.get(st["state"], 0) + 1
        for state, c in counts.items():
            self._m_replicas.set(c, state=state)
