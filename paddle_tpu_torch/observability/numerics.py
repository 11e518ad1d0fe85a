"""Numerics observability (counterpart of
``paddle_tpu/observability/numerics.py``): whether the numbers are still
numbers.

- **probe math** — :func:`stats_row` / :func:`tensor_stats`: cheap
  per-tensor reductions in :data:`STAT_FIELDS` order (nonfinite count,
  absmax, rms, zero-frac and the low-precision under/overflow fractions),
  a ``float32[6]`` tensor on the input's device — computing it never
  syncs.
- **the stream** — producers :func:`submit` a stats table (a device
  tensor, ``[n, 6]``) under a stream name; :func:`poll` /
  :func:`maybe_poll` resolve it to the host OFF the dispatch path (the
  one sync), export the ``numerics.{nonfinite,absmax,rms,underflow_frac}
  {site=,tensor=}`` gauges and feed the anomaly engine.  The serving
  engine's guarded dispatches submit their logits' row as stream
  ``serving/<replica>``.
- **anomaly engine** — :class:`NumericsMonitor`: first-nonfinite
  occurrence, grad-norm explosion and loss spikes (rolling median + MAD),
  ONE flight-recorder dump per episode (``reason="numerics"``).
  ``poll(raise_on_fault=True)`` (or ``level="abort"``) turns a fresh
  non-finite episode into a :class:`~..resilience.retry.NumericFault`.
- **eager check** — :func:`check_numerics` (one tensor) against the
  active :class:`TensorCheckerConfig`'s level.
- **the serving guard's hooks** — :func:`serving_guard_default` (what
  ``ServingEngine(numeric_guard=None)`` resolves to) and the
  ``numerics.nan_inject`` fault site (:func:`consume_nan_inject`): NaN
  once per trip, else 0.0, which a guarded dispatch adds to the logits of
  lane :func:`nan_inject_row`, so arming a fault never changes what the
  dispatch computes for the other lanes.

- **in-program probes** — :func:`capture` turns on the layer tap (one
  process-wide ``torch.nn`` module forward hook, installed while any
  capture region is active and removed after the last one) so a probed
  TrainStep, or an eager region, records one stats row per module output
  under the reference's site names: the module's qualified name from
  :func:`layer_names` where the caller gave one, else its class name
  lower-cased (paddle's ``_name_scope``) with ``#k`` on repeats.
  :func:`probe_token` / :func:`probe_cadence` key the probed TrainStep
  variant: 0 when the checker is off, and then every step is the unprobed
  one.  :class:`OperatorStatsCollector` / :func:`collect_operator_stats`
  are the eager spelling (``paddle.amp.debugging``'s context manager).

The ``/statusz`` "numerics" section renders the last RESOLVED tables only
— scrapes never touch the device.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..profiler import metrics as _metrics
from . import faults as _faults

__all__ = [
    "STAT_FIELDS", "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "check_numerics", "collect_operator_stats",
    "tensor_stats", "stats_row", "capture", "submit", "poll", "maybe_poll",
    "probe_token", "probe_cadence", "checker_enabled", "monitor",
    "serving_guard_default", "consume_nan_inject", "set_nan_inject_row",
    "nan_inject_row", "latest", "statusz", "reset", "Anomaly",
    "NumericsMonitor", "OperatorStatsCollector", "layer_names",
]

STAT_FIELDS = ("nonfinite", "absmax", "rms", "zero_frac",
               "underflow_frac", "overflow_frac")
NSTATS = len(STAT_FIELDS)

# normal-range limits the under/overflow fractions measure against: the
# fraction of values a cast to the low-precision grid would flush to zero
# (|x| below the smallest normal) or saturate (|x| above the largest
# finite).  bf16 shares float32's exponent range; fp16 is the narrow one.
_RANGES = {
    "bfloat16": (1.1754944e-38, 3.3895314e38),
    "float16": (6.104e-05, 65504.0),
    "float32": (1.1754944e-38, 3.4028235e38),
}

_LEVELS = ("warn", "dump", "abort")

# float32's smallest normal: the reference's reductions run under XLA,
# which flushes float32 subnormals to zero, so they count as zeros there
_F32_TINY = 1.1754944e-38


# ------------------------------------------------------------- probe math
def stats_row(x, low_dtype="bfloat16"):
    """The probe: one ``float32[6]`` row of reductions over ``x`` in
    :data:`STAT_FIELDS` order, on ``x``'s device.  Asynchronous on the
    card (no host sync; the shape is read on the host) — two passes over
    the tensor, O(1) output.  Float32 subnormals count as zeros, as in the
    reference (XLA flushes them), so the low-precision fractions agree."""
    f = torch.as_tensor(x).detach().reshape(-1).to(torch.float32)
    f = torch.where(f.abs() < _F32_TINY, 0.0, f)
    n = max(f.numel(), 1)
    tiny, huge = _RANGES.get(str(low_dtype), _RANGES["bfloat16"])
    finite = torch.isfinite(f)
    nonfinite = (~finite).sum().to(torch.float32)
    a = torch.where(finite, f, 0.0).abs()
    absmax = a.max() if f.numel() else a.new_zeros(())
    rms = torch.sqrt((a * a).sum() / n)
    inv_n = 1.0 / n
    zero_frac = (a == 0).sum().to(torch.float32) * inv_n
    underflow = ((a > 0) & (a < tiny)).sum().to(torch.float32) * inv_n
    overflow = ((a > huge).sum().to(torch.float32) + nonfinite) * inv_n
    return torch.stack([nonfinite, absmax, rms, zero_frac, underflow,
                        overflow]).to(torch.float32)


def tensor_stats(x, low_dtype="bfloat16"):
    """Eager spelling of :func:`stats_row`: a ``{field: float}`` dict
    (syncs: the row comes to the host)."""
    row = stats_row(x, low_dtype=low_dtype).cpu().numpy()
    return {k: float(v) for k, v in zip(STAT_FIELDS, row)}


# ----------------------------------------------------------- configuration
@dataclass
class TensorCheckerConfig:
    """``paddle.amp.debugging.TensorCheckerConfig``-shaped switchboard (the
    reference config's fields this port reads).

    ``level`` governs what a detection does: ``"warn"`` warns, ``"dump"``
    also fires one flight-recorder dump per episode, ``"abort"`` also
    raises (``FloatingPointError`` from :func:`check_numerics`,
    :class:`~..resilience.retry.NumericFault` from :func:`poll`).
    ``include``/``exclude`` are name-substring filters over probe / check
    sites; ``cadence`` is how often a TrainStep runs its probed variant
    (every Nth step); ``serving_guard`` is the default for
    ``ServingEngine(numeric_guard=None)``; ``nan_inject_site`` names the
    probed site ``numerics.nan_inject`` poisons (None: the first); the
    anomaly engine's spike test is a rolling median + MAD over ``window``
    samples, firing above ``median + mad_threshold * MAD`` after
    ``min_history`` samples."""

    enable: bool = True
    level: str = "dump"
    include: tuple = ()
    exclude: tuple = ()
    cadence: int = 1
    low_dtype: str = "bfloat16"
    serving_guard: bool = False
    nan_inject_site: str | None = None
    window: int = 64
    mad_threshold: float = 10.0
    min_history: int = 8

    def __post_init__(self):
        if self.level not in _LEVELS:
            raise ValueError(f"level must be one of {_LEVELS}, got "
                             f"{self.level!r}")
        if isinstance(self.include, str):
            self.include = (self.include,)
        if isinstance(self.exclude, str):
            self.exclude = (self.exclude,)
        self.include = tuple(self.include or ())
        self.exclude = tuple(self.exclude or ())
        self.cadence = max(1, int(self.cadence))

    def match(self, name):
        name = str(name)
        if any(s in name for s in self.exclude):
            return False
        if self.include:
            return any(s in name for s in self.include)
        return True


# ------------------------------------------------------------ process state
_LOCK = threading.Lock()
_CONFIG: TensorCheckerConfig | None = None
_VERSION = 0                     # bumps on enable/disable -> probe_token
_PROVIDER_REGISTERED = False
_TLS = threading.local()
_ACTIVE_CAPTURES = 0
_HOOK = None                     # the module forward hook while capturing

_PENDING: dict = {}              # stream -> (sites, device stats, step)
_LATEST: dict = {}               # stream -> {"sites", "table", "step", "ts"}
_last_poll = 0.0

_nan_trips_seen = 0
_NAN_INJECT_ROW = 0

_MONITOR = None


def enable_tensor_checker(config=None, **kw):
    """Install ``config`` (or ``TensorCheckerConfig(**kw)``) as the active
    configuration; returns it."""
    global _CONFIG, _VERSION
    cfg = config if config is not None else TensorCheckerConfig(**kw)
    with _LOCK:
        _CONFIG = cfg
        _VERSION += 1
    _ensure_provider()
    return cfg


def disable_tensor_checker():
    """Disarm: probe tokens return 0, and a TrainStep runs its unprobed
    variant again."""
    global _CONFIG, _VERSION
    with _LOCK:
        _CONFIG = None
        _VERSION += 1


def config():
    return _CONFIG


def checker_enabled():
    cfg = _CONFIG
    return cfg is not None and cfg.enable


def level():
    cfg = _CONFIG
    return cfg.level if cfg is not None else "warn"


def probe_token():
    """Program-variant key component: 0 when probes are off (producers
    then run exactly their unprobed step), a fresh non-zero integer per
    enable so a stale probed variant never aliases a new one."""
    return _VERSION if checker_enabled() else 0


def probe_cadence():
    cfg = _CONFIG
    return cfg.cadence if (cfg is not None and cfg.enable) else 1


def serving_guard_default():
    cfg = _CONFIG
    return bool(cfg is not None and cfg.enable and cfg.serving_guard)


def low_dtype():
    cfg = _CONFIG
    return cfg.low_dtype if cfg is not None else "bfloat16"


def _match(name):
    cfg = _CONFIG
    return cfg.match(name) if cfg is not None else True


# ------------------------------------------------------- capture machinery
class _Capture:
    """Collector of (site, stats-row) pairs fed by the layer tap.
    ``inject`` (a float32 scalar on the host, or a 0-d tensor) is ADDED to
    the output of the matching site — the ``numerics.nan_inject`` poison
    point.  A host 0.0 (the disarmed value) adds nothing, so a disarmed
    probed step computes exactly what the unprobed one does."""

    def __init__(self, stream="trace", names=None, inject=None,
                 inject_site=None, low_dtype="bfloat16", eager=False):
        self.stream = stream
        self.sites: list = []
        self.rows: list = []
        self.eager = eager
        self.inject = inject
        self.inject_site = inject_site
        self.low = low_dtype
        self._names = names or {}
        self._counts: dict = {}
        self._injected = False

    def _name_for(self, layer):
        name = self._names.get(id(layer))
        if name is None:
            base = getattr(layer, "_name_scope", type(layer).__name__.lower())
            k = self._counts.get(base, 0)
            self._counts[base] = k + 1
            name = base if k == 0 else f"{base}#{k}"
        return name

    def _inject_here(self, name):
        if self.inject is None or self._injected:
            return False
        if self.inject_site is None:
            return True                       # first probed site
        return self.inject_site in name

    def add(self, name, value):
        """Manual probe site (loss, grads, logits)."""
        if not _match(name):
            return
        self.sites.append(str(name))
        self.rows.append(stats_row(value, low_dtype=self.low))

    def tap(self, layer, out):
        arr = _first_array(out)
        if arr is None:
            return out
        name = self._name_for(layer)
        if not _match(name):
            return out
        if self._inject_here(name):
            self._injected = True
            inj = self.inject
            if isinstance(inj, torch.Tensor) or float(inj) != 0.0:
                poisoned = arr + torch.as_tensor(
                    inj, device=arr.device).to(arr.dtype)
                out = _replace_array(out, poisoned)
                arr = poisoned
        self.sites.append(name)
        self.rows.append(stats_row(arr, low_dtype=self.low))
        return out

    def stack(self):
        """``(sites, float32[n, 6])`` — the stats table on the device."""
        if not self.rows:
            return (), torch.zeros((0, NSTATS), dtype=torch.float32)
        return tuple(self.sites), torch.stack(self.rows)

    def summary(self):
        """``{site: {field: float}}`` in call order (syncs)."""
        out = {}
        if not self.rows:
            return out
        table = torch.stack(self.rows).cpu().numpy()
        for name, row in zip(self.sites, table):
            out[name] = {k: float(v) for k, v in zip(STAT_FIELDS, row)}
        return out


def _first_array(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)) and out:
        return _first_array(out[0])
    return None


def _replace_array(out, arr):
    if isinstance(out, torch.Tensor):
        return arr
    if isinstance(out, (tuple, list)) and out:
        head = _replace_array(out[0], arr)
        rest = list(out[1:])
        return type(out)([head] + rest) if isinstance(out, list) \
            else (head,) + tuple(rest)
    return out


def _layer_tap(module, args, out):
    stack = getattr(_TLS, "captures", None)
    if not stack:
        return None
    new = stack[-1].tap(module, out)
    return None if new is out else new


def _set_hook(active):
    """Install (or remove) the process-wide module forward hook — the
    counterpart of the reference's ``nn.Layer.__call__`` tap.  Modules
    called on other threads pass through it untouched (no capture on
    their thread)."""
    global _HOOK
    if active and _HOOK is None:
        _HOOK = torch.nn.modules.module.register_module_forward_hook(
            _layer_tap)
    elif not active and _HOOK is not None:
        _HOOK.remove()
        _HOOK = None


@contextmanager
def capture(stream="trace", names=None, inject=None, inject_site=None,
            eager=False):
    """Activate the layer tap on this thread; yields the
    :class:`_Capture` whose ``stack()`` / ``summary()`` the caller reads
    after the region."""
    global _ACTIVE_CAPTURES
    cap = _Capture(stream=stream, names=names, inject=inject,
                   inject_site=inject_site, low_dtype=low_dtype(),
                   eager=eager)
    stack = getattr(_TLS, "captures", None)
    if stack is None:
        stack = _TLS.captures = []
    stack.append(cap)
    with _LOCK:
        _ACTIVE_CAPTURES += 1
        _set_hook(True)
    try:
        yield cap
    finally:
        stack.pop()
        with _LOCK:
            _ACTIVE_CAPTURES -= 1
            if _ACTIVE_CAPTURES == 0:
                _set_hook(False)


def layer_names(model):
    """``{id(module): qualified_name}`` for capture naming — the model
    itself under its lower-cased class name (paddle's ``_name_scope``),
    every submodule under its ``named_modules`` path, which is the
    reference's ``named_sublayers`` path (the port keeps its names)."""
    out = {id(model): getattr(model, "_name_scope",
                              type(model).__name__.lower())}
    for name, sub in model.named_modules():
        if name:
            out[id(sub)] = name
    return out


# --------------------------------------------------- device table lifecycle
def submit(stream, sites, dev_stats, step=0):
    """Producer side: park the latest device stats table (``[n, 6]``, or
    one ``[6]`` row) for ``stream``.  Never syncs — resolution happens in
    :func:`poll`, off the dispatch path.  Only the newest table per
    stream is kept."""
    if not sites:
        return
    with _LOCK:
        _PENDING[stream] = (tuple(sites), dev_stats, int(step))


def poll(stream=None, raise_on_fault=None):
    """Resolve pending device tables to the host (the one sync), export
    the ``numerics.*`` gauges and run the anomaly engine.  Returns the
    list of NEW anomaly episodes.  ``raise_on_fault=True`` (or
    ``level="abort"``) raises :class:`~..resilience.retry.NumericFault`
    on a fresh non-finite episode."""
    with _LOCK:
        if stream is None:
            items = list(_PENDING.items())
            _PENDING.clear()
        else:
            items = [(stream, _PENDING.pop(stream))] \
                if stream in _PENDING else []
    episodes = []
    for strm, (sites, dev, step) in items:
        table = torch.as_tensor(dev).detach().to("cpu", torch.float32) \
            .reshape(-1, NSTATS).numpy()
        with _LOCK:
            _LATEST[strm] = {"sites": sites, "table": table,
                             "step": step, "ts": time.time()}
        _export_gauges(strm, sites, table)
        episodes.extend(monitor().observe(strm, sites, table, step))
    if raise_on_fault is None:
        raise_on_fault = level() == "abort"
    if raise_on_fault:
        for ep in episodes:
            if ep.kind == "nonfinite":
                from ..resilience.retry import NumericFault

                raise NumericFault(
                    f"non-finite values at {ep.site!r} "
                    f"(stream={ep.stream}, step={ep.step})",
                    site=ep.site, stream=ep.stream, step=ep.step)
    return episodes


def maybe_poll(min_interval_s=0.5):
    """Throttled :func:`poll` for hot loops: at most one resolve per
    ``min_interval_s``, nothing to do when no table is pending."""
    global _last_poll
    if not _PENDING:
        return []
    now = time.monotonic()
    if now - _last_poll < min_interval_s:
        return []
    _last_poll = now
    return poll()


def latest(stream=None):
    """Last resolved stats: the whole dict, or one stream's entry."""
    with _LOCK:
        if stream is not None:
            return _LATEST.get(stream)
        return dict(_LATEST)


def _export_gauges(stream, sites, table):
    g_nonfinite = _metrics.gauge(
        "numerics.nonfinite", "non-finite element count per probed tensor")
    g_absmax = _metrics.gauge(
        "numerics.absmax", "absolute max per probed tensor (finite values)")
    g_rms = _metrics.gauge(
        "numerics.rms", "root-mean-square per probed tensor (finite values)")
    g_underflow = _metrics.gauge(
        "numerics.underflow_frac",
        "fraction of values below the low-precision normal range")
    for i, site in enumerate(sites):
        labels = {"site": stream, "tensor": site}
        g_nonfinite.set(float(table[i, 0]), **labels)
        g_absmax.set(float(table[i, 1]), **labels)
        g_rms.set(float(table[i, 2]), **labels)
        g_underflow.set(float(table[i, 4]), **labels)


# ------------------------------------------------------------ fault site
def consume_nan_inject():
    """The ``numerics.nan_inject`` site: returns ``float32("nan")`` when
    an armed fault tripped since the last call, else ``0.0``."""
    global _nan_trips_seen
    with _LOCK:
        # baseline BEFORE tripping: a re-armed site starts a fresh spec at
        # trips=0, so reading only after maybe() would swallow its first
        # trip (1 == the stale seen-count from the exhausted spec)
        before = _faults.trip_count("numerics.nan_inject")
        if before < _nan_trips_seen:       # faults.clear()/re-arm reset
            _nan_trips_seen = before
    _faults.maybe("numerics.nan_inject")
    trips = _faults.trip_count("numerics.nan_inject")
    with _LOCK:
        fired = trips > _nan_trips_seen
        _nan_trips_seen = trips
    return np.float32("nan") if fired else np.float32(0.0)


def set_nan_inject_row(row):
    """Serving: which batch lane the next tripped ``nan_inject`` poisons
    (default 0)."""
    global _NAN_INJECT_ROW
    _NAN_INJECT_ROW = int(row)


def nan_inject_row():
    return _NAN_INJECT_ROW


# ---------------------------------------------------------- anomaly engine
@dataclass
class Anomaly:
    kind: str                    # nonfinite | grad_explosion | loss_spike
    stream: str
    step: int
    site: str
    value: float
    dump: str | None = None


class NumericsMonitor:
    """First-nonfinite, grad-norm-explosion and loss-spike detection over
    resolved stats tables; one flight-recorder dump per EPISODE (an
    episode re-arms when the stream goes clean again)."""

    def __init__(self):
        self._hist: dict = {}            # (stream, kind) -> deque
        self._active: set = set()        # (stream, kind) in-episode
        self._episodes: deque = deque(maxlen=32)
        self._m_anomalies = _metrics.counter(
            "numerics.anomalies", "numeric anomaly episodes by kind")

    # ------------------------------------------------------------ observe
    def observe(self, stream, sites, table, step):
        cfg = _CONFIG or TensorCheckerConfig(enable=False)
        out = []
        nf = np.flatnonzero(table[:, 0] > 0) if len(table) else np.array([])
        key = (stream, "nonfinite")
        if nf.size:
            if key not in self._active:
                self._active.add(key)
                i = int(nf[0])
                out.append(self._fire("nonfinite", stream, step, sites[i],
                                      float(table[i, 0]), sites, table))
        else:
            self._active.discard(key)

        gi = [i for i, s in enumerate(sites) if s.startswith("grad")]
        if gi and not np.any(table[gi, 0] > 0):
            gnorm = float(np.sqrt(np.sum(table[gi, 2] ** 2)))
            a = self._spike("grad_explosion", stream, step, "grad_norm",
                            gnorm, cfg, sites, table)
            if a:
                out.append(a)
        if "loss" in sites:
            i = sites.index("loss")
            if not table[i, 0] > 0:
                a = self._spike("loss_spike", stream, step, "loss",
                                float(table[i, 2]), cfg, sites, table)
                if a:
                    out.append(a)
        return out

    def observe_loss(self, value, stream="train", step=0):
        """Host-side loss feed for eager loops without probes."""
        v = float(value)
        if not np.isfinite(v):
            key = (stream, "nonfinite")
            if key in self._active:
                return []
            self._active.add(key)
            return [self._fire("nonfinite", stream, step, "loss", v,
                               ("loss",), np.array([[1.0] + [0.0] * 5]))]
        self._active.discard((stream, "nonfinite"))
        cfg = _CONFIG or TensorCheckerConfig(enable=False)
        a = self._spike("loss_spike", stream, step, "loss", v, cfg,
                        ("loss",), np.zeros((1, NSTATS)))
        return [a] if a else []

    # ------------------------------------------------------------ details
    def _spike(self, kind, stream, step, site, value, cfg, sites, table):
        if not np.isfinite(value):
            return None
        key = (stream, kind)
        hist = self._hist.setdefault(key, deque(maxlen=cfg.window))
        fired = None
        if len(hist) >= cfg.min_history:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med)))
            floor = max(abs(med) * 1e-3, 1e-12)
            thresh = med + cfg.mad_threshold * max(mad, floor)
            if value > thresh:
                if key not in self._active:
                    self._active.add(key)
                    fired = self._fire(kind, stream, step, site, value,
                                       sites, table)
            else:
                self._active.discard(key)
        if key not in self._active:
            hist.append(value)           # keep the baseline clean
        return fired

    def _fire(self, kind, stream, step, site, value, sites, table):
        self._m_anomalies.inc(kind=kind)
        lvl = level()
        dump = None
        if lvl in ("dump", "abort"):
            from . import flight_recorder as _flight

            rows = [dict(zip(STAT_FIELDS, (float(x) for x in table[i])),
                         tensor=sites[i]) for i in range(len(sites))]
            dump = _flight.get_flight_recorder().dump(
                "numerics", extra={"kind": kind, "stream": stream,
                                   "step": step, "site": site,
                                   "value": value, "stats": rows})
        else:
            warnings.warn(
                f"numerics: {kind} at {site!r} (stream={stream}, "
                f"step={step}, value={value!r})", RuntimeWarning,
                stacklevel=3)
        ep = Anomaly(kind=kind, stream=stream, step=step, site=site,
                     value=value, dump=dump)
        self._episodes.append(ep)
        return ep

    def episodes(self):
        return list(self._episodes)

    def reset(self):
        self._hist.clear()
        self._active.clear()
        self._episodes.clear()


def monitor() -> NumericsMonitor:
    global _MONITOR
    if _MONITOR is None:
        with _LOCK:
            if _MONITOR is None:
                _MONITOR = NumericsMonitor()
    return _MONITOR


# ------------------------------------------------------------- eager API
def check_numerics(x, name="tensor", stream="eager"):
    """Eager one-shot check (``paddle.amp.debugging.check_numerics``):
    returns the stats dict; on non-finite values acts per the active
    checker level (warn / one dump per episode / raise
    ``FloatingPointError``)."""
    stats = tensor_stats(x, low_dtype=low_dtype())
    if stats["nonfinite"] > 0 and _match(name):
        _metrics.counter(
            "numerics.checks", "eager check_numerics calls that found "
            "non-finite values").inc()
        row = np.array([[stats[k] for k in STAT_FIELDS]])
        key = (f"{stream}/{name}", "nonfinite")
        mon = monitor()
        if key not in mon._active:
            mon._active.add(key)
            mon._fire("nonfinite", f"{stream}/{name}", 0, name,
                      stats["nonfinite"], (name,), row)
        if level() == "abort":
            raise FloatingPointError(
                f"non-finite values in {name!r}: "
                f"{int(stats['nonfinite'])} element(s)")
    elif stats["nonfinite"] == 0:
        monitor()._active.discard((f"{stream}/{name}", "nonfinite"))
    return stats


class OperatorStatsCollector:
    """Eager per-layer stats over a region — the
    ``collect_operator_stats`` context manager's payload.  Rides the same
    layer tap the probed TrainStep uses."""

    def __init__(self, model=None, stream="eager"):
        self.stream = stream
        self._names = layer_names(model) if model is not None else None
        self._cm = None
        self._cap = None

    def start(self):
        self._cm = capture(stream=self.stream, names=self._names,
                           eager=True)
        self._cap = self._cm.__enter__()

    def stop(self):
        if self._cm is None:
            return
        self._cm.__exit__(None, None, None)
        self._cm = None

    def summary(self):
        return self._cap.summary() if self._cap is not None else {}

    def report(self):
        lines = [" | ".join(["site".ljust(28)] + [f.rjust(14)
                                                  for f in STAT_FIELDS])]
        for site, stats in self.summary().items():
            lines.append(" | ".join(
                [site[:28].ljust(28)]
                + [f"{stats[f]:14.6g}" for f in STAT_FIELDS]))
        return "\n".join(lines)


@contextmanager
def collect_operator_stats(model=None, stream="eager"):
    """``with collect_operator_stats() as col: ...`` — eager per-layer
    tensor stats (``col.summary()`` / ``col.report()``), checking each
    layer output against the active level on exit."""
    col = OperatorStatsCollector(model=model, stream=stream)
    col.start()
    try:
        yield col
    finally:
        col.stop()
        for site, stats in col.summary().items():
            if stats["nonfinite"] > 0:
                check_numerics(np.float32("nan"), name=site, stream=stream)


# ---------------------------------------------------------------- statusz
def _ensure_provider():
    """Register the /statusz ``numerics`` section once, lazily on first
    enable — a process that never arms the checker never grows the key."""
    global _PROVIDER_REGISTERED
    if _PROVIDER_REGISTERED:
        return
    with _LOCK:
        if _PROVIDER_REGISTERED:
            return
        from . import telemetry as _telemetry

        _telemetry.add_status_provider("numerics", statusz)
        _PROVIDER_REGISTERED = True


def statusz():
    """The ``/statusz`` section: config, last RESOLVED tables, recent
    anomaly episodes and the amp scaler series (None where the port
    exports none).  Never touches the device (pending tables are counted,
    not resolved)."""
    cfg = _CONFIG
    with _LOCK:
        resolved = {
            strm: {"step": ent["step"], "ts": ent["ts"],
                   "tensors": [dict(zip(STAT_FIELDS,
                                        (float(x) for x in ent["table"][i])),
                                    tensor=ent["sites"][i])
                               for i in range(len(ent["sites"]))]}
            for strm, ent in _LATEST.items()}
        pending = sorted(_PENDING)
    eps = [{"kind": e.kind, "stream": e.stream, "step": e.step,
            "site": e.site, "value": e.value, "dump": e.dump}
           for e in monitor().episodes()[-8:]]
    reg = _metrics.get_registry()
    amp = {}
    for name in ("amp.loss_scale", "amp.found_inf", "amp.scale_decr"):
        m = reg.get(name)
        amp[name.split(".", 1)[1]] = m.get() if m is not None else None
    return {
        "enabled": bool(cfg is not None and cfg.enable),
        "level": cfg.level if cfg else None,
        "cadence": cfg.cadence if cfg else None,
        "probe_token": probe_token(),
        "streams": resolved,
        "pending": pending,
        "episodes": eps,
        "amp": amp,
    }


def reset():
    """Tests: disarm the checker, drop pending/resolved tables, anomaly
    history and fault-site bookkeeping (the provider registration
    survives)."""
    global _CONFIG, _VERSION, _nan_trips_seen, _NAN_INJECT_ROW, _last_poll
    with _LOCK:
        _CONFIG = None
        _VERSION += 1
        _PENDING.clear()
        _LATEST.clear()
        _nan_trips_seen = 0
        _NAN_INJECT_ROW = 0
        _last_poll = 0.0
    if _MONITOR is not None:
        _MONITOR.reset()
