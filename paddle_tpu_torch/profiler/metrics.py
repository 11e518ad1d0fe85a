"""Process-wide metrics registry with JSONL and Prometheus-text exporters
(counterpart of ``paddle_tpu/profiler/metrics.py``, a copy of it: that
module imports no JAX, and this package keeps its own registry, so the
port's families never land in the reference's).

Counters, gauges and histograms, labelled, scrapeable, and cheap enough to
leave on in the hot path (a labelled counter increment is one dict lookup
+ one locked float add; ``+=`` alone is not atomic).

Env flags (README, the port's "Observability" part):

- ``PADDLE_METRICS_DIR``: when set, a daemon flusher thread periodically
  writes ``metrics.jsonl`` and ``metrics.prom`` snapshots into this dir.
- ``PADDLE_METRICS_FLUSH_SECS``: flush period (default 30).
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time

_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
_RESERVOIR = 512  # raw samples kept per histogram child for quantile()


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v):
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name):
    """Registry names are dotted (train_step.mfu); the Prometheus text
    format only allows [a-zA-Z_:][a-zA-Z0-9_:]* — sanitize on render so
    the JSONL schema keeps the readable dotted spelling."""
    name = _PROM_NAME_BAD.sub("_", name)
    return "_" + name if name and name[0].isdigit() else name


def _prom_escape(v):
    """Label-VALUE escaping per the exposition format (one bad value must
    not make the whole scrape unparseable)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Child:
    """One (metric, labelset) time series.  Mutations hold the per-child
    lock: ``self.value += x`` is NOT atomic under CPython (a thread switch
    between the load and store loses updates)."""

    __slots__ = ("labels", "value", "_lock")

    def __init__(self, labels):
        self.labels = dict(labels)
        self.value = 0.0
        self._lock = threading.Lock()


class _Metric:
    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        key = _label_key(labels)
        c = self._children.get(key)
        if c is None:
            with self._lock:
                c = self._children.setdefault(key, self._new_child(labels))
        return c

    def _new_child(self, labels):
        return _Child(labels)

    # the no-label spelling: counter.inc(1) == counter.labels().inc(1)
    def _default(self):
        return self.labels()

    def samples(self):
        """Yield (suffix, labels, value) rows for exporters."""
        for c in self._children.values():
            yield "", c.labels, c.value

    def get(self, **labels):
        c = self._children.get(_label_key(labels))
        return c.value if c is not None else None

    def total(self):
        """Sum over every labelled series (counters: the grand total)."""
        return sum(c.value for c in self._children.values())


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self, labels):
        return _CounterChild(labels)

    def inc(self, amount=1.0, **labels):
        self.labels(**labels).inc(amount)


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value):
        self.value = float(value)  # single store: atomic

    def inc(self, amount=1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount=1.0):
        with self._lock:
            self.value -= amount


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self, labels):
        return _GaugeChild(labels)

    def set(self, value, **labels):
        self.labels(**labels).set(value)

    def inc(self, amount=1.0, **labels):
        self.labels(**labels).inc(amount)


class _HistogramChild(_Child):
    __slots__ = ("buckets", "bucket_counts", "sum", "count", "_reservoir")

    def __init__(self, labels, buckets):
        super().__init__(labels)
        self.buckets = buckets
        self.bucket_counts = [0] * (len(buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self._reservoir = collections.deque(maxlen=_RESERVOIR)

    def observe(self, value):
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            self._reservoir.append(v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    def quantile(self, q):
        """Quantile over the last ``_RESERVOIR`` raw observations (exact on
        small test runs; a sliding-window estimate in production)."""
        if not self._reservoir:
            return None
        xs = sorted(self._reservoir)
        i = min(int(q * len(xs)), len(xs) - 1)
        return xs[i]

    @property
    def mean(self):
        return self.sum / self.count if self.count else None


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", buckets=None):
        super().__init__(name, help)
        self._buckets = tuple(sorted(buckets)) if buckets else _DEFAULT_BUCKETS

    def _new_child(self, labels):
        return _HistogramChild(labels, self._buckets)

    @property
    def buckets(self):
        return self._buckets

    def set_buckets(self, buckets):
        """Re-edge this metric: future children use the new buckets, and
        existing UNOBSERVED children are rebuilt on them.  Children that
        already hold observations keep their old edges — cumulative bucket
        counts cannot be rebinned after the fact — with a loud warning, so
        configure buckets before traffic flows (e.g. the serving engine
        aligns ``serving.ttft/itl`` edges with its SLO thresholds at
        construction)."""
        new = tuple(sorted(set(float(b) for b in buckets)))
        if not new:
            raise ValueError("set_buckets needs at least one edge")
        with self._lock:
            if new == self._buckets:
                return
            self._buckets = new
            observed = []
            for key, c in list(self._children.items()):
                if c.count:
                    observed.append(c.labels)
                    continue
                self._children[key] = _HistogramChild(c.labels, new)
        if observed:
            import warnings

            warnings.warn(
                f"histogram {self.name!r}: set_buckets left "
                f"{len(observed)} already-observed child(ren) on their old "
                f"edges (counts cannot be rebinned): {observed}",
                stacklevel=2)

    def observe(self, value, **labels):
        self.labels(**labels).observe(value)

    # the inherited _Child.value is dead for histograms — report observed
    # sums so e.g. total() over a *_seconds histogram means total seconds
    def get(self, **labels):
        c = self._children.get(_label_key(labels))
        return c.sum if c is not None else None

    def total(self):
        return sum(c.sum for c in self._children.values())

    def samples(self):
        for c in self._children.values():
            cum = 0
            for b, n in zip(c.buckets, c.bucket_counts):
                cum += n
                yield "_bucket", dict(c.labels, le=repr(float(b))), cum
            yield "_bucket", dict(c.labels, le="+Inf"), c.count
            yield "_sum", c.labels, c.sum
            yield "_count", c.labels, c.count


class MetricsRegistry:
    """Names -> metrics.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent), so instrumented modules can grab their
    handles without coordinating registration order."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name, help="") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=None) -> Histogram:
        """Get-or-create; ``buckets`` on an EXISTING metric MERGES the
        requested edges into the current ones via
        :meth:`Histogram.set_buckets` (per-metric configurable edges —
        instrumented modules can align a shared histogram's buckets with
        their thresholds without coordinating creation order, and two
        callers with different thresholds both keep theirs: replacement
        here would silently destroy the first caller's alignment).
        ``set_buckets`` itself stays a full replacement for deliberate
        re-edging."""
        h = self._get_or_create(Histogram, name, help, buckets=buckets)
        if buckets is not None:
            merged = set(h.buckets) | {float(b) for b in buckets}
            if merged != set(h.buckets):
                h.set_buckets(merged)
        return h

    def get(self, name):
        return self._metrics.get(name)

    def metrics(self):
        return list(self._metrics.values())

    def reset(self):
        """Drop every series (tests; production registries live forever)."""
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ exporters
    def collect(self):
        """Flat sample rows: [{name, kind, labels, value}] — one schema for
        JSONL and the Prometheus renderer."""
        rows = []
        for m in self.metrics():
            for suffix, labels, value in m.samples():
                rows.append({"name": m.name + suffix, "kind": m.kind,
                             "labels": dict(labels), "value": value})
        return rows

    def to_jsonl(self):
        ts = time.time()
        return "".join(json.dumps(dict(r, time=ts)) + "\n"
                       for r in self.collect())

    def export_jsonl(self, path, append=True):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a" if append else "w") as f:
            f.write(self.to_jsonl())
        return path

    def to_prometheus(self):
        """Prometheus text exposition format v0.0.4."""
        out = []
        for m in self.metrics():
            name = _prom_name(m.name)
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            for suffix, labels, value in m.samples():
                if labels:
                    lab = ",".join(
                        f'{_PROM_LABEL_BAD.sub("_", str(k))}="{_prom_escape(v)}"'
                        for k, v in sorted(labels.items()))
                    out.append(f"{name}{suffix}{{{lab}}} {_fmt_value(value)}")
                else:
                    out.append(f"{name}{suffix} {_fmt_value(value)}")
        return "\n".join(out) + "\n"

    def export_prometheus(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return path

    def export_snapshot(self, dir_name):
        """THE snapshot recipe (the flusher, :func:`flush`): metrics.prom
        replaced, metrics.jsonl appended.  Returns the jsonl path."""
        os.makedirs(dir_name, exist_ok=True)
        self.export_prometheus(os.path.join(dir_name, "metrics.prom"))
        return self.export_jsonl(os.path.join(dir_name, "metrics.jsonl"))


def load_jsonl(path):
    """Round-trip reader for export_jsonl output."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


class BoundLabels:
    """A metric view with constant labels pre-merged into every call.

    The registry is process-wide, so N instances of one subsystem in one
    process (e.g. N ``ServingEngine`` replicas) would otherwise stamp the
    SAME ``serving.*`` series.  ``bind(metric, replica="3")`` gives each
    instance a handle whose ``inc``/``observe``/``set``/``get`` forward
    with the bound labels merged under any per-call labels (``inc(
    status="ok")`` lands on the ``{replica="3", status="ok"}`` child)."""

    __slots__ = ("_metric", "_labels")

    def __init__(self, metric, **labels):
        self._metric = metric
        self._labels = {str(k): str(v) for k, v in labels.items()}

    def _merged(self, labels):
        return {**self._labels, **labels} if labels else self._labels

    def inc(self, amount=1.0, **labels):
        self._metric.inc(amount, **self._merged(labels))

    def dec(self, amount=1.0, **labels):
        self._metric.labels(**self._merged(labels)).dec(amount)

    def set(self, value, **labels):
        self._metric.set(value, **self._merged(labels))

    def observe(self, value, **labels):
        self._metric.observe(value, **self._merged(labels))

    def get(self, **labels):
        return self._metric.get(**self._merged(labels))

    @property
    def metric(self):
        return self._metric


def bind(metric, **labels):
    """See :class:`BoundLabels`."""
    return BoundLabels(metric, **labels)


# ----------------------------------------------------------- default registry
_REGISTRY = MetricsRegistry()
_FLUSHER = None
_FLUSHER_LOCK = threading.Lock()
_FLUSHER_STOP = threading.Event()


def get_registry() -> MetricsRegistry:
    maybe_start_flusher()
    return _REGISTRY


def counter(name, help=""):
    return get_registry().counter(name, help)


def gauge(name, help=""):
    return get_registry().gauge(name, help)


def histogram(name, help="", buckets=None):
    return get_registry().histogram(name, help, buckets=buckets)


def flush(dir_name=None):
    """Write one snapshot (metrics.jsonl appended, metrics.prom replaced)."""
    d = dir_name or os.environ.get("PADDLE_METRICS_DIR")
    if not d:
        return None
    _REGISTRY.export_snapshot(d)
    return d


def maybe_start_flusher():
    """Start the env-gated background flusher once (daemon; exits with the
    process).  No-op unless PADDLE_METRICS_DIR is set."""
    global _FLUSHER
    if _FLUSHER is not None or not os.environ.get("PADDLE_METRICS_DIR"):
        return None
    with _FLUSHER_LOCK:
        if _FLUSHER is not None:  # lost the race: someone else started it
            return _FLUSHER
        period = float(os.environ.get("PADDLE_METRICS_FLUSH_SECS", "30"))

        def loop():
            while not _FLUSHER_STOP.wait(period):
                try:
                    flush()
                except Exception:
                    pass

        _FLUSHER = threading.Thread(target=loop, name="paddle-metrics-flusher",
                                    daemon=True)
        _FLUSHER.start()
    return _FLUSHER


def stop_flusher():
    global _FLUSHER
    with _FLUSHER_LOCK:
        t = _FLUSHER
        if t is None:
            return
        _FLUSHER_STOP.set()
        t.join(timeout=5)
        if t.is_alive():
            # mid-flush on a slow disk: leave the stop flag set (it exits at
            # its next wait()) and keep _FLUSHER so no duplicate starts
            return
        _FLUSHER = None
        _FLUSHER_STOP.clear()
