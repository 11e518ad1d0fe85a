"""ServingCluster — the replicated, routed serving service (counterpart of
``paddle_tpu/serving/cluster/service.py``): a :class:`~.pool.ReplicaPool`
of engines behind a :class:`~.router.PrefixAffinityRouter`, with
cross-replica resilience.

Request lifecycle::

    cluster.submit(prompt)                      (caller thread)
      └─ router.route(prompt, pool states)      health-aware decision
         └─ engines[i].submit(...)              one "leg" on replica i
    monitor thread (one per cluster, poll-driven):
      forwards each leg's tokens to the caller's ClusterHandle; when a leg
      dies with its replica (engine stopped, fatal error), re-routes the
      request onto a surviving replica as prompt + tokens-so-far with the
      remaining budget, so a greedy request's final ids are the
      uninterrupted run's.  Tokens already streamed stay streamed.

A replica's own transient-failure restart is invisible here (the engine
re-queues its own in-flight work).  The cluster path engages only when a
replica is lost: a fatal error, a burned restart budget, a plain
``stop()`` or a ``cluster.replica_preempt@<replica>`` trip.

Health-aware admission: replicas reading ``draining`` / ``stopped`` /
``error`` get no traffic; with none routable the submit sheds with
:class:`~..engine.RequestRejectedError` (reason ``no_routable_replica``,
or ``draining`` when every replica drains).  A leg a saturated engine
rejects spills to the next-best routable replica first.

Observability: ``cluster.requests{replica=}``, ``cluster.affinity{result=
hit|miss}``, ``cluster.affinity_hit_rate``, ``cluster.rerouted_requests``,
``cluster.rejected{reason=}``, ``cluster.routable_replicas``,
``cluster.in_flight`` (and the autoscaler's ``cluster.replicas{state=}``,
``cluster.scale_events{direction=}``) in the port's registry, each with
``cluster=<name>``; a ``cluster`` section on ``/statusz`` and a
``cluster`` component on ``/healthz`` (healthy while any replica is
routable); ``cluster.route`` spans carry the decision around each leg's
``serving.submit``.
"""

from __future__ import annotations

import itertools
import logging
import queue as _queue
import threading
import time

from ...observability import tracing as _tracing
from ...profiler import metrics as _metrics
from ..engine import (EngineStoppedError, RequestHandle,
                      RequestRejectedError, SamplingParams, ServingEngine)
from .pool import ReplicaPool
from .router import ROUTABLE_STATES, PrefixAffinityRouter

#: leg terminal statuses that mean "the replica died under the request",
#: not "the request reached its own end"
_REPLICA_LOST = ("stopped", "error")

_logger = logging.getLogger(__name__)


class ClusterHandle(RequestHandle):
    """Caller-side view of a cluster request — the same ``result()`` /
    ``stream()`` / ``cancel()`` surface as the engine's
    :class:`RequestHandle`, accumulated across however many replica legs
    the request needed.  ``replica_history`` lists the replicas that
    served it (length > 1 ⇒ it survived a replica loss)."""

    def __init__(self, request_id, prompt, max_new_tokens, sampling,
                 eos_token_id, deadline, adapter=None, grammar=None,
                 mode="generate", pooling="mean", tier=None):
        super().__init__(request_id, len(prompt))
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.deadline = deadline            # absolute time.time(), or None
        # multi-tenant fields ride the outer handle so failover legs
        # re-submit with the same tenant/grammar/mode — and the QoS tier
        # rides the same way, so a rerouted leg keeps its priority
        self.adapter = adapter
        self.grammar = grammar
        self.mode = mode
        self.pooling = pooling
        self.tier = tier
        self.replica_history = []
        self._inner = None                  # current leg's engine handle
        self._legs = 0

    def cancel(self):
        super().cancel()
        inner = self._inner
        if inner is not None:
            inner.cancel()


class ServingCluster:
    """See module docstring.  Typical use::

        cluster = ServingCluster(model, replicas=2, prefix_sharing=True)
        with cluster:
            h = cluster.submit(prompt, max_new_tokens=64)
            ids = h.result(timeout=120)

    ``**engine_kwargs`` configure every replica (num_slots, page_size,
    prefix_sharing, ...) — including ``warmup=`` (a
    :class:`~...observability.programs.WarmupManifest` or saved
    path), which the pool replays on every replica before its scheduler
    starts so the cluster's first request on any replica mints zero
    traces.  Pass a prebuilt ``pool=`` / ``router=`` to override
    construction; ``policy`` picks the routing policy (``affinity``
    default, ``random`` / ``round_robin`` / ``least_loaded`` as
    controls).  With ``prefix_cache="radix"`` replicas the affinity
    policy routes to the replica holding the DEEPEST resident prefix
    match (pool states carry each radix index's digest summary),
    falling back to rendezvous for cold prefixes; ``prefix_match=False``
    restores pure rendezvous placement."""

    def __init__(self, model=None, replicas=2, devices=None, pool=None,
                 router=None, policy="affinity", affinity_tokens=None,
                 saturation_queue=None, seed=0, prefix_match=True,
                 max_reroutes=None, poll_s=0.002, replica_prefix="",
                 name=None, slo=None, qos=None, autoscale=None,
                 **engine_kwargs):
        if pool is None:
            if model is None:
                raise ValueError("need a model (or a prebuilt pool=)")
            # replicas report on /healthz but don't gate it — this
            # cluster's own any-replica-routable component does
            engine_kwargs.setdefault("health_gating", False)
            if slo is not None:
                # per-replica accounting too: each engine evaluates the
                # legs it served under its replica= label (a prebuilt
                # pool= configures its own engines)
                engine_kwargs.setdefault("slo", slo)
            if qos is not None:
                # one QoSConfig is immutable and safely shared: every
                # replica gets the same tier table (queues stay per-engine)
                engine_kwargs.setdefault("qos", qos)
            pool = ReplicaPool(model, replicas=replicas, devices=devices,
                               replica_prefix=replica_prefix,
                               **engine_kwargs)
        self._pool = pool
        n = len(pool)
        if router is None:
            if affinity_tokens is None:
                # page-aligned default: two BlockManager prefix pages —
                # prompts sharing this window share at least those pages
                affinity_tokens = 2 * pool.engines[0].page_size
            router = PrefixAffinityRouter(
                n, affinity_tokens=affinity_tokens, policy=policy,
                saturation_queue=saturation_queue, seed=seed,
                prefix_match=prefix_match)
        if router.n_replicas != n:
            raise ValueError(f"router built for {router.n_replicas} "
                             f"replicas, pool has {n}")
        self._router = router
        # cluster identity, mirroring the engines' replica= fix: two pools
        # in one process (replica_prefix) must not share cluster.* series
        # or the "cluster" provider key.  Default "0" keeps the provider
        # key at plain "cluster".
        self.name = str(name) if name is not None \
            else (replica_prefix.strip("/") or "0")
        self._provider_key = "cluster" if self.name == "0" \
            else f"cluster/{self.name}"
        self._max_reroutes = int(max_reroutes) if max_reroutes is not None \
            else n
        self._poll_s = float(poll_s)
        self._lock = threading.Lock()
        # elastic membership: routing decisions and router resizes are
        # serialized so a route never runs against a half-applied resize
        self._route_lock = threading.Lock()
        self._autoscaler = None
        if autoscale:
            from ..qos import AutoScaler

            if isinstance(autoscale, AutoScaler):
                self._autoscaler = autoscale
            else:
                kw = dict(autoscale) if isinstance(autoscale, dict) else {}
                kw.setdefault("cluster", self.name)
                # the scale-up burn signal: the worst protected-tier burn
                # across the fleet (0.0 on non-QoS engines)
                kw.setdefault("burn_source", self._qos_burn)
                self._autoscaler = AutoScaler(pool, **kw)
        self._inflight: set[ClusterHandle] = set()
        self._rid = itertools.count()
        self._started = False
        self._stopping = False
        self._mon_stop = threading.Event()
        self._mon_thread = None
        self._status_provider = None
        self._health_provider = None
        self._aff_hits = 0
        self._aff_misses = 0
        self._rerouted_total = 0
        # cluster-wide SLO accounting over the OUTER handles: failover
        # legs and reroute overhead land here, not in any one replica's
        # numbers (serving.slo.* series carry cluster=<name>)
        self._slo = None
        if slo is not None:
            from ...observability.slo import SLOAccountant, SLOPolicy

            if not isinstance(slo, SLOPolicy):
                raise TypeError(f"slo must be an SLOPolicy, got {slo!r}")
            self._slo = SLOAccountant(slo, cluster=self.name)

        # every cluster.* series carries cluster=<name> (default "0") so
        # two pools in one process keep distinct series, mirroring the
        # engines' replica= label
        def _c(mname, help):
            return _metrics.bind(_metrics.counter(mname, help),
                                 cluster=self.name)

        def _g(mname, help):
            return _metrics.bind(_metrics.gauge(mname, help),
                                 cluster=self.name)

        self._m_requests = _c(
            "cluster.requests", "request legs routed, by replica")
        self._m_affinity = _c(
            "cluster.affinity", "routing decisions by result=hit|miss "
            "(hit = landed on the prefix's affine replica)")
        self._m_hit_rate = _g(
            "cluster.affinity_hit_rate",
            "affinity hits / routing decisions, lifetime")
        self._m_rerouted = _c(
            "cluster.rerouted_requests",
            "in-flight requests re-routed off a lost replica")
        self._m_rejected = _c(
            "cluster.rejected", "cluster-level submit rejections, by reason")
        self._m_routable = _g(
            "cluster.routable_replicas", "replicas accepting traffic now")
        self._m_inflight = _g(
            "cluster.in_flight", "cluster requests not yet terminal")

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._started:
            return self
        self._pool.start()
        self._stopping = False
        self._mon_stop.clear()
        self._mon_thread = threading.Thread(
            target=self._monitor, name="paddle-serving-cluster", daemon=True)
        self._started = True
        self._mon_thread.start()
        from ...observability import telemetry as _telemetry

        self._status_provider = self._statusz
        _telemetry.add_status_provider(self._provider_key,
                                       self._status_provider)
        self._health_provider = self.health_state
        _telemetry.add_health_provider(self._provider_key,
                                       self._health_provider)
        return self

    def drain(self, timeout=600):
        """Graceful rundown: every replica drains (no new admissions),
        then wait for the monitor to propagate the last terminal events."""
        self._pool.drain(timeout=timeout)
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    return True
            time.sleep(self._poll_s)
        raise TimeoutError(f"cluster did not drain within {timeout}s")

    def stop(self, drain=False, drain_timeout=600):
        """Stop every replica and the monitor.  ``drain=True`` finishes
        in-flight work first; without it, in-flight requests fail fast
        with :class:`EngineStoppedError` (never re-routed — a cluster
        shutdown is not a replica failure)."""
        if not self._started:
            return
        if drain:
            self.drain(timeout=drain_timeout)
        with self._lock:  # submits registered after this are rejected
            self._stopping = True
        try:
            self._pool.stop()
            # the engines just failed any remaining handles; let the
            # monitor forward those terminal events to the outer handles
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._inflight:
                        break
                time.sleep(self._poll_s)
            with self._lock:
                leftovers = list(self._inflight)
                self._inflight.clear()
            for h in leftovers:  # belt and braces: never leave a waiter
                h._error = EngineStoppedError(
                    f"request {h.request_id} still unresolved at cluster "
                    "stop()")
                self._finish_outer(h, "stopped")
        finally:
            self._mon_stop.set()
            if self._mon_thread is not None:
                self._mon_thread.join(timeout=30)
                self._mon_thread = None
            from ...observability import telemetry as _telemetry

            _telemetry.remove_providers_if_owner(
                self._provider_key, self._status_provider,
                self._health_provider)
            self._status_provider = None
            self._health_provider = None
            self._started = False
            self._stopping = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------ api
    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               eos_token_id=None, deadline_s=None, sampling=None,
               adapter=None, grammar=None, mode="generate", pooling="mean",
               tier=None):
        """Route one request onto a replica; returns a
        :class:`ClusterHandle` immediately.  ``adapter`` (LoRA tenant),
        ``grammar`` (constrained decoding) and ``mode`` (generate | embed
        | score) forward to the replica engines — multi-tenant pools only
        (``ReplicaPool(lora_store=...)``); adapter-named requests route by
        ADAPTER affinity so a tenant's weights page into one replica.
        ``tier`` names the request's QoS tier (QoS-enabled pools only)
        and rides every failover leg."""
        prompt = ServingEngine._normalize_prompt(prompt_ids)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.start()
        sampling = sampling if sampling is not None \
            else SamplingParams(temperature=temperature)
        deadline = time.time() + deadline_s if deadline_s is not None \
            else None
        if grammar is not None and eos_token_id is None:
            eos_token_id = grammar.eos_token_id
        h = ClusterHandle(f"c{next(self._rid)}", prompt,
                          int(max_new_tokens), sampling, eos_token_id,
                          deadline, adapter=adapter, grammar=grammar,
                          mode=mode, pooling=pooling, tier=tier)
        # register BEFORE the leg, atomically with the stopping check: a
        # submit racing stop() either rejects here or its handle is seen
        # by stop()'s leftover sweep — never a live handle nobody pumps
        with self._lock:
            if self._stopping:
                raise EngineStoppedError(
                    f"cluster {self.name} is stopping; request "
                    f"{h.request_id} not admitted")
            self._inflight.add(h)
            self._m_inflight.set(len(self._inflight))
        try:
            self._submit_leg(h, prompt, h.max_new_tokens, deadline_s)
        except BaseException as e:
            # EVERY failed first leg must unregister the handle — not
            # just engine rejections: a multi-tenant validation error
            # (ValueError/KeyError from an unknown adapter or a
            # mismatched grammar) would otherwise leave a never-finished
            # handle in _inflight for the monitor to pump forever
            with self._lock:
                self._inflight.discard(h)
                self._m_inflight.set(len(self._inflight))
            if isinstance(e, RequestRejectedError):
                self._m_rejected.inc(reason=e.reason)
            raise
        return h

    def generate(self, prompt_ids, max_new_tokens=32, timeout=None, **kw):
        return self.submit(prompt_ids, max_new_tokens, **kw).result(timeout)

    def stream(self, prompt_ids, max_new_tokens=32, **kw):
        return self.submit(prompt_ids, max_new_tokens, **kw).stream()

    # ------------------------------------------------------------- routing
    def _submit_leg(self, h, prompt, max_new, deadline_s):
        """Route + submit one leg (caller OR monitor thread).  A rejection
        from the chosen engine (bounded queue, deadline shed) spills to
        the next-best routable replica before surfacing."""
        # one atomic (engines, states) snapshot: with an autoscaler the
        # membership can change between routing and submission, so every
        # index below is into THIS snapshot, never the live pool list
        engines, states = self._pool.snapshot_states()
        with self._route_lock:
            if self._router.n_replicas != len(states):
                self._router.resize(len(states))
            dec = self._router.route(prompt, states, adapter=h.adapter)
        self._m_routable.set(sum(1 for st in states
                                 if st["state"] in ROUTABLE_STATES))
        if dec is None:
            reason = "draining" if states and all(
                st["state"] == "draining" for st in states) \
                else "no_routable_replica"
            raise RequestRejectedError(
                f"no routable replica for request {h.request_id} "
                f"(states: {[st['state'] for st in states]})", reason=reason)
        order = [dec.replica] + sorted(
            (i for i, st in enumerate(states)
             if i != dec.replica and st["state"] in ROUTABLE_STATES),
            key=lambda i: states[i]["queue_depth"] + states[i]["active"])
        last_rejection = None
        for idx in order:
            eng = engines[idx]
            # the full RouteDecision rides the span as REAL attributes
            # (OTLP/chrome export them as-is), so failover forensics read
            # affine/hit/reason off the trace instead of grepping logs
            with _tracing.span("cluster.route", trace_id=h.trace_id,
                               request_id=h.request_id, replica=eng.replica,
                               affine=engines[dec.affine].replica,
                               hit=idx == dec.affine, policy=dec.policy,
                               reason=dec.reason, leg=h._legs + 1):
                try:
                    fsm_state = None
                    if h.grammar is not None and h.token_ids:
                        # failover resume: replay the emitted tokens so
                        # the new leg's FSM starts mid-document, exactly
                        # where the lost replica left the grammar
                        fsm_state = h.grammar.advance_seq(
                            h.grammar.start, h.token_ids)
                    inner = eng.submit(
                        prompt, max_new_tokens=max_new,
                        eos_token_id=h.eos_token_id, deadline_s=deadline_s,
                        sampling=h.sampling, adapter=h.adapter,
                        grammar=h.grammar, mode=h.mode, pooling=h.pooling,
                        tier=h.tier, _fsm_state=fsm_state,
                        _autostart=False)
                except (RequestRejectedError, RuntimeError) as e:
                    # RequestRejectedError: engine shed it (bounded queue,
                    # deadline, draining).  RuntimeError (incl. Engine-
                    # StoppedError): the engine died or stopped between the
                    # states() snapshot and this submit — _autostart=False
                    # keeps a leg from resurrecting a stopped replica.
                    # Either way: spill to the next-best replica.
                    last_rejection = e
                    continue
            h._inner = inner
            if h.cancelled:  # cancel raced the leg hand-off: chase it
                inner.cancel()
            h._legs += 1
            h.replica_history.append(eng.replica)
            hit = idx == dec.affine
            self._m_requests.inc(replica=eng.replica)
            self._m_affinity.inc(result="hit" if hit else "miss")
            with self._lock:  # callers and the monitor both submit legs
                if hit:
                    self._aff_hits += 1
                else:
                    self._aff_misses += 1
                total = self._aff_hits + self._aff_misses
                self._m_hit_rate.set(self._aff_hits / total)
            return
        if isinstance(last_rejection, RequestRejectedError):
            raise last_rejection  # every routable replica rejected it
        raise RequestRejectedError(
            f"every routable replica failed request {h.request_id}: "
            f"{last_rejection!r}", reason="no_routable_replica")

    # ------------------------------------------------------------- monitor
    def _monitor(self):
        while not self._mon_stop.is_set():
            self._pump()
            if self._autoscaler is not None and not self._stopping:
                try:
                    self._autoscaler.tick()
                except Exception:
                    # a scaling hiccup (replica ctor raced a device error,
                    # say) must never kill the monitor: requests in flight
                    # depend on this thread pumping their tokens
                    _logger.exception("autoscaler tick failed")
            self._mon_stop.wait(self._poll_s)
        self._pump()  # final sweep so stop()-time events still land

    def _pump(self):
        with self._lock:
            entries = list(self._inflight)
        for h in entries:
            inner = h._inner
            if inner is None:
                continue
            try:
                while True:
                    try:
                        kind, val = inner._events.get_nowait()
                    except _queue.Empty:
                        break
                    if kind == "token":
                        self._forward_token(h, val)
                    else:
                        self._on_leg_done(h, inner, val)
                        break
            except BaseException as e:  # a broken handle must not hang the
                h._inner = None         # rest of the fleet's monitoring
                h._error = e
                self._finish_outer(h, "error")

    def _forward_token(self, h, tok):
        now = time.time()
        if h.first_token_at is None:
            h.first_token_at = now
        h.token_ids.append(tok)
        # outer token timeline: what the CALLER observed, including any
        # cross-replica failover gap (the cluster's SLO truth)
        h.token_times.append(now)
        h._events.put(("token", tok))

    def _on_leg_done(self, h, inner, status):
        # fold the leg's QoS eviction count into the caller-visible total
        # BEFORE deciding on reroute — a rerouted leg's preemptions count
        h.preemptions += getattr(inner, "preemptions", 0)
        if status in _REPLICA_LOST and not self._stopping \
                and not h.cancelled and self._try_reroute(h):
            return
        h._inner = None
        h._error = inner._error
        h.value = inner.value           # embed vector / score list
        self._finish_outer(h, status)

    def _try_reroute(self, h):
        """The replica under ``h`` is gone: re-queue the request on a
        surviving replica as prompt + tokens-so-far with the remaining
        budget (greedy ids stay exactly the uninterrupted ones — the
        engine's requeue invariant across the replica boundary).  Returns False when the
        request can't be re-routed (reroute budget burned, nothing
        routable, every survivor rejected it)."""
        if h._legs > self._max_reroutes:
            return False
        remaining = h.max_new_tokens - len(h.token_ids) \
            if h.mode == "generate" else 1    # embed/score: just re-run
        if remaining <= 0:   # it had finished; the loss beat the retire
            h._inner = None
            self._finish_outer(h, "completed")
            return True
        deadline_s = None
        if h.deadline is not None:
            deadline_s = h.deadline - time.time()
            if deadline_s <= 0:
                h._inner = None
                self._finish_outer(h, "expired")
                return True
        prompt = h.prompt + [int(t) for t in h.token_ids]
        try:
            self._submit_leg(h, prompt, remaining, deadline_s)
        except RequestRejectedError:
            return False
        with self._lock:
            self._rerouted_total += 1
        self._m_rerouted.inc()
        return True

    def _finish_outer(self, h, status):
        h.status = status
        h.finished_at = time.time()
        if self._slo is not None and status in ("completed", "expired") \
                and h.mode == "generate":
            self._slo.observe(h, met_override=False
                              if status == "expired" else None)
        with self._lock:
            self._inflight.discard(h)
            self._m_inflight.set(len(self._inflight))
        h._events.put(("done", status))
        h._done.set()

    # --------------------------------------------------------------- health
    def health_state(self):
        """Cluster-level health for a load balancer: ``healthy`` while any
        replica is healthy, ``degraded`` while any is at least routable,
        ``draining`` when every replica is draining, else ``error`` —
        the OPPOSITE fold of /healthz's worst-component rule, because one
        lost replica must not 503 the whole cluster."""
        states = [st["state"] for st in self._pool.states()]
        if any(s == "healthy" for s in states):
            return {"state": "healthy", "reasons": []}
        if any(s == "degraded" for s in states):
            return {"state": "degraded",
                    "reasons": [f"replica_states:{states}"]}
        if states and all(s == "draining" for s in states):
            return {"state": "draining", "reasons": ["all replicas draining"]}
        if states and all(s == "stopped" for s in states):
            return {"state": "stopped", "reasons": []}
        return {"state": "error",
                "reasons": [f"no routable replica: {states}"]}

    @property
    def health(self):
        return self.health_state()["state"]

    def _qos_burn(self):
        """Autoscaler burn signal: the WORST protected-tier burn rate
        across the fleet (one hot replica is an incident even when its
        siblings are idle); None when no engine accounts a tier SLO."""
        rates = [e.qos_burn_rate() for e in list(self._pool.engines)
                 if hasattr(e, "qos_burn_rate")]
        return max(rates) if rates else None

    # -------------------------------------------------------------- insight
    @property
    def pool(self):
        return self._pool

    @property
    def router(self):
        return self._router

    @property
    def autoscaler(self):
        """The cluster's :class:`~..qos.AutoScaler`
        (None unless ``autoscale=`` was set)."""
        return self._autoscaler

    @property
    def slo_accountant(self):
        """Cluster-wide SLO accountant (None unless ``slo=`` was set)."""
        return self._slo

    @property
    def engines(self):
        return self._pool.engines

    def register_adapter(self, adapter):
        """Register a LoRA adapter on every distinct store behind the
        fleet (one shared store registers once) — multi-tenant pools
        only."""
        stores = []
        for e in self._pool.engines:
            store = getattr(e, "lora_store", None)
            if store is None:
                raise ValueError(
                    f"replica {e.replica} has no lora_store; build the "
                    "cluster with ReplicaPool(lora_store=...)")
            if not any(store is s for s in stores):
                stores.append(store)
        for store in stores:
            store.register(adapter)
        return adapter.name

    def affinity_hit_rate(self):
        total = self._aff_hits + self._aff_misses
        return self._aff_hits / total if total else None

    def stats(self):
        # LOCKLESS snapshot (len() is atomic enough for a diagnostic):
        # /statusz renders this while callers and the monitor churn, and a
        # scrape must never queue behind — or hold — the cluster lock
        inflight = len(self._inflight)
        from ...observability import memory as _obs_memory

        return {
            "replicas": self._pool.stats(),
            "policy": self._router.policy,
            "affinity_tokens": self._router.affinity_tokens,
            "in_flight": inflight,
            "rerouted_requests": self._rerouted_total,
            "affinity": {"hits": self._aff_hits,
                         "misses": self._aff_misses,
                         "hit_rate": self.affinity_hit_rate()},
            # per-replica device-memory rollup off the process ledger —
            # owner_rows only, no live-array walk, still lockless
            "memory": _obs_memory.ledger().replica_rollup(
                [e.replica for e in self._pool.engines]),
        }

    def _statusz(self):
        """/statusz ``cluster`` section: the router's view of the fleet."""
        st = self.stats()
        st["started"] = self._started
        st["health"] = self.health_state()
        if self._slo is not None:
            st["slo"] = self._slo.summary()
        if self._autoscaler is not None:
            sc = self._autoscaler
            st["autoscaler"] = {
                "min_replicas": sc.min_replicas,
                "max_replicas": sc.max_replicas,
                "replicas": len(self._pool),
                "retiring": sc.retiring.replica
                if sc.retiring is not None else None,
                "timeline": sc.timeline(),
            }
        per = {}
        engines, states = self._pool.snapshot_states()
        for snap, e in zip(states, engines):
            per[e.replica] = {
                "state": snap["state"],
                "reasons": snap["reasons"],
                "queue_depth": snap["queue_depth"],
                "active_slots": snap["active"],
                "occupancy": snap["active"] / max(snap["num_slots"], 1),
                "page_utilization": e.block_manager.utilization(),
            }
        st["replica_health"] = per
        return st
