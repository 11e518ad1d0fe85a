"""QoS-tiered serving: priority tiers, weighted admission, deliberate
preemption and SLO-aware brownouts (counterpart of
``paddle_tpu/serving/qos.py``; its :class:`AutoScaler` waits for cluster
serving).

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

The mechanism half — eviction, requeue as prompt + tokens-so-far with
the remaining budget — is the engine's restart-recovery requeue
scheduled on purpose, so a preempted greedy request's final ids are the
ones an uninterrupted run gives.
"""

from __future__ import annotations

import collections
import dataclasses

from ..observability.slo import SLOPolicy

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
