"""Request-level SLO accounting for the serving engine (counterpart of
``paddle_tpu/observability/slo.py``).

A latency SLO is a per-REQUEST promise: "first token within X, every
subsequent token within Y, done within Z".

- :class:`SLOPolicy` — the targets (any subset of TTFT / ITL / e2e) plus
  the attainment ``objective`` the burn rate is judged against;
- :class:`RequestTimeline` / :func:`timeline_of` — the token-level
  timeline of one request, from the timestamps the engine stamps on its
  handles (``submitted_at``, per-token ``token_times``, ``finished_at``);
- :class:`SLOAccountant` — evaluates each finished request, keeps a
  rolling window, and exports ``serving.slo.requests{met=}``,
  ``serving.slo.{good_tokens,tokens}`` counters and
  ``serving.slo.{attainment,burn_rate,goodput_tokens_per_sec,
  tokens_per_sec}`` gauges.  Goodput: tokens of requests that MET their
  SLO, per second — a replica decoding fast but blowing TTFT scores zero
  goodput, which raw tokens/sec hides.
- :func:`slo_histogram_buckets` — latency histogram edges aligned with
  the SLO thresholds.

Wiring: ``ServingEngine(slo=SLOPolicy(...))`` accounts per engine
(``replica=`` label); QoS tiers with a policy get one accountant each
(``tier=`` too), whose burn rate drives the brownout ladder
(:mod:`..serving.qos`).  Every derived gauge is an exact function of the
per-request timelines (the window), so tests can recompute them.
"""

from __future__ import annotations

import collections
import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Latency targets (seconds).  ``None`` disables a check.  A request
    MEETS the SLO iff every configured check passes: TTFT <= ttft_s,
    every inter-token gap <= itl_s, finish - submit <= e2e_s.

    ``objective`` is the attainment target the burn rate is judged
    against: burn_rate = (1 - attainment) / (1 - objective) — 1.0 means
    the error budget burns exactly as fast as it refills, >1 is an
    incident in progress.  ``window`` is the rolling-request window the
    attainment/goodput gauges are computed over."""

    ttft_s: float | None = None
    itl_s: float | None = None
    e2e_s: float | None = None
    objective: float = 0.99
    window: int = 256

    def evaluate(self, tl: "RequestTimeline") -> "SLOReport":
        ttft = tl.ttft
        ttft_ok = (self.ttft_s is None or ttft is None
                   or ttft <= self.ttft_s)
        gaps = tl.itl_gaps
        viol = (sum(1 for g in gaps if g > self.itl_s)
                if self.itl_s is not None else 0)
        e2e = tl.e2e
        e2e_ok = (self.e2e_s is None or e2e is None or e2e <= self.e2e_s)
        met = bool(ttft_ok and e2e_ok and viol == 0 and tl.tokens > 0)
        return SLOReport(ttft=ttft, ttft_ok=ttft_ok,
                         itl_max=max(gaps) if gaps else None,
                         itl_violations=viol, e2e=e2e, e2e_ok=e2e_ok,
                         tokens=tl.tokens,
                         good_tokens=tl.tokens if met else 0, met=met)

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RequestTimeline:
    """One request's token-level timeline (absolute wall-clock seconds):
    admission, each token emission, completion."""

    submitted_at: float
    token_times: tuple
    finished_at: float | None = None

    @property
    def tokens(self):
        return len(self.token_times)

    @property
    def ttft(self):
        if not self.token_times:
            return None
        return self.token_times[0] - self.submitted_at

    @property
    def itl_gaps(self):
        ts = self.token_times
        return [ts[i] - ts[i - 1] for i in range(1, len(ts))]

    @property
    def e2e(self):
        end = self.finished_at if self.finished_at is not None \
            else (self.token_times[-1] if self.token_times else None)
        return None if end is None else end - self.submitted_at


@dataclasses.dataclass(frozen=True)
class SLOReport:
    ttft: float | None
    ttft_ok: bool
    itl_max: float | None
    itl_violations: int
    e2e: float | None
    e2e_ok: bool
    tokens: int
    good_tokens: int
    met: bool


def timeline_of(handle) -> RequestTimeline:
    """Timeline from a serving ``RequestHandle`` / ``ClusterHandle`` (the
    engine stamps ``submitted_at`` at submit, appends to ``token_times``
    at every emission, sets ``finished_at`` at retirement)."""
    return RequestTimeline(
        submitted_at=handle.submitted_at,
        token_times=tuple(getattr(handle, "token_times", ())),
        finished_at=handle.finished_at)


class SLOAccountant:
    """Evaluates finished requests against one policy and keeps the
    rolling window, keeping the ``serving.slo.*`` series current.
    ``labels`` (``replica=``, ``tier=``) pre-merge into every series."""

    def __init__(self, policy: SLOPolicy, registry=None, **labels):
        from ..profiler import metrics as _metrics

        self.policy = policy
        self.labels = dict(labels)
        reg = registry if registry is not None else _metrics.get_registry()

        def _b(m):
            return _metrics.bind(m, **labels) if labels else m

        self._m_requests = _b(reg.counter(
            "serving.slo.requests", "finished requests by SLO outcome"))
        self._m_good_tokens = _b(reg.counter(
            "serving.slo.good_tokens",
            "tokens of requests that met their SLO (goodput numerator)"))
        self._m_tokens = _b(reg.counter(
            "serving.slo.tokens", "tokens of all SLO-evaluated requests"))
        self._m_attainment = _b(reg.gauge(
            "serving.slo.attainment",
            "SLO-met fraction over the rolling request window"))
        self._m_burn = _b(reg.gauge(
            "serving.slo.burn_rate",
            "(1 - attainment) / (1 - objective); >1 burns error budget"))
        self._m_goodput = _b(reg.gauge(
            "serving.slo.goodput_tokens_per_sec",
            "SLO-met tokens/sec over the rolling window"))
        self._m_tps = _b(reg.gauge(
            "serving.slo.tokens_per_sec",
            "all tokens/sec over the same window (goodput's denominator "
            "twin: the gap between the two is SLO-missed throughput)"))
        # window rows: (submitted_at, finished_at, tokens, good_tokens, met)
        self._window = collections.deque(maxlen=int(policy.window))
        self._lock = threading.Lock()
        self._evaluated = 0
        self._met = 0

    # ---------------------------------------------------------------- feed
    def observe(self, handle, met_override=None) -> SLOReport:
        """Evaluate one finished request and refresh counters/gauges.
        ``met_override=False`` forces a miss regardless of the timeline
        (deadline-expired requests missed by definition).

        A miss that would have been a MET had the request not waited out a
        kernel build (the engine accumulates ``handle.compile_s``) is
        labelled ``cause=cold_start`` — a distinct child of the same
        counter, so total misses remain the sum across causes."""
        tl = timeline_of(handle)
        rep = self.policy.evaluate(tl)
        if met_override is not None and rep.met != bool(met_override):
            rep = dataclasses.replace(
                rep, met=bool(met_override),
                good_tokens=rep.tokens if met_override else 0)
        cause = None
        compile_s = float(getattr(handle, "compile_s", 0.0) or 0.0)
        if not rep.met and met_override is None and compile_s > 0.0:
            # re-evaluate the counterfactual timeline with the build stall
            # subtracted from every stamp after submission
            warm = RequestTimeline(
                submitted_at=tl.submitted_at,
                token_times=tuple(t - compile_s for t in tl.token_times),
                finished_at=None if tl.finished_at is None
                else tl.finished_at - compile_s)
            if self.policy.evaluate(warm).met:
                cause = "cold_start"
        end = tl.finished_at if tl.finished_at is not None \
            else tl.submitted_at
        with self._lock:
            self._window.append(
                (tl.submitted_at, end, rep.tokens, rep.good_tokens, rep.met))
            self._evaluated += 1
            self._met += 1 if rep.met else 0
            rows = list(self._window)
        if cause is not None:
            self._m_requests.inc(met="false", cause=cause)
        else:
            self._m_requests.inc(met="true" if rep.met else "false")
        self._m_tokens.inc(rep.tokens)
        if rep.good_tokens:
            self._m_good_tokens.inc(rep.good_tokens)
        self._refresh(rows)
        return rep

    @staticmethod
    def window_rates(rows, objective):
        """The derived rates as an exact, reproducible function of the
        window rows."""
        if not rows:
            return None
        met = sum(1 for r in rows if r[4])
        attainment = met / len(rows)
        burn = (1.0 - attainment) / max(1.0 - objective, 1e-9)
        span = max(r[1] for r in rows) - min(r[0] for r in rows)
        tokens = sum(r[2] for r in rows)
        good = sum(r[3] for r in rows)
        tps = tokens / span if span > 0 else 0.0
        goodput = good / span if span > 0 else 0.0
        return {"attainment": attainment, "burn_rate": burn,
                "tokens_per_sec": tps, "goodput_tokens_per_sec": goodput,
                "window": len(rows), "met": met, "tokens": tokens,
                "good_tokens": good, "window_span_s": span}

    def _refresh(self, rows):
        rates = self.window_rates(rows, self.policy.objective)
        if rates is None:
            return
        self._m_attainment.set(rates["attainment"])
        self._m_burn.set(rates["burn_rate"])
        self._m_goodput.set(rates["goodput_tokens_per_sec"])
        self._m_tps.set(rates["tokens_per_sec"])

    # -------------------------------------------------------------- insight
    def current(self):
        """The current window's derived rates (the :func:`window_rates`
        dict), or None before any request finished — the burn-rate scalar
        the QoS brownout ladder polls."""
        with self._lock:
            rows = list(self._window)
        return self.window_rates(rows, self.policy.objective)

    def summary(self):
        """Policy + the current window's derived rates + lifetime counts."""
        with self._lock:
            rows = list(self._window)
            evaluated, met = self._evaluated, self._met
        out = {"policy": self.policy.to_dict(),
               "evaluated": evaluated, "met": met,
               "lifetime_attainment": met / evaluated if evaluated else None}
        rates = self.window_rates(rows, self.policy.objective)
        if rates is not None:
            out["window"] = rates
        return out


def slo_histogram_buckets(default_buckets, *targets):
    """Histogram edges aligned with SLO thresholds: the default latency
    buckets plus each configured target and its half/double — so "what
    fraction of samples beat the target" is answerable from the
    ``_bucket`` series alone."""
    edges = set(default_buckets)
    for t in targets:
        if t:
            edges.update((round(t * 0.5, 9), round(float(t), 9),
                          round(t * 2.0, 9)))
    return tuple(sorted(edges))
