"""Program-lifecycle observability (counterpart of
``paddle_tpu/observability/programs.py``): who minted which program, who
paid for it, and how never to pay twice.

A *program* is one step of the port bound to a static key: an engine's
``serve_step``, ``serve_prefill/<bucket>``, ``serve_prefill_chunk/<c>``
and ``verify/k<k>``, ``generate()``'s ``generate.decode`` and each
``TrainStep`` input signature.  Its key lands in the model's program store
(:func:`~paddle_tpu_torch.text.models._decode.program_store`) once, the
reference's keys spelled the reference's way (pool dtypes as
``"bfloat16"``), so a manifest saved by either package loads into the
other.  On the card a serving or generate program is a CUDA graph
(:mod:`paddle_tpu_torch.jit.graphs`): its first dispatch builds and loads
the kernels (``nvcc``), runs the step eagerly and captures it; every later
dispatch replays it.  On the CPU it is the eager step bound to its key.

:class:`ProgramLedger` (process-wide, :func:`ledger`)
    One row per mint: store key, perf family, replica, device, cold or
    warm provenance, the observed first-dispatch stall (``compile_s``:
    the ``nvcc`` build the dispatch waited out, the eager run and the
    capture) and the trace id of the request that paid it.  A lazy
    analysis per row (:func:`~.perf.jit_analysis_thunk`) splits the stall
    into ``backend_compile_s`` (the ``nvcc`` wall) and ``trace_s`` (eager
    run + capture) and adds flops, bytes and the graph pool's bytes, on
    demand, never on a scrape.  Exports ``programs.{compiled_total,
    compile_seconds,stall_seconds}{family=,replica=}`` and the
    ``programs.compile_in_progress`` gauge, renders the ``/statusz``
    ``programs`` section, and drops ONE flight-recorder dump per
    cold-start episode whose stall exceeds ``PADDLE_COLD_START_BUDGET_S``
    (default 30 s, <= 0 disables).

    The engine's first-dispatch sites open a :meth:`compile window
    <ProgramLedger.compile_window>` around the stall: it marks
    ``engine._compiling`` (the watchdog reads :meth:`ProgramLedger
    .compiling` and treats a capture in progress as slow, not stuck),
    holds the in-progress gauge up, and bills the stall to every waiting
    request's ``compile_s`` (the TTFT decomposition).

:class:`WarmupManifest`
    A store's key set as JSON: :meth:`WarmupManifest.capture` on a warm
    process, ``ServingEngine.warmup(manifest)`` on a cold one, which
    replays each key with an inert dispatch before admission, so the first
    real request mints nothing.

Scrape-path rule: :meth:`ProgramLedger.statusz` reads plain fields under
the ledger lock; it never runs a program, builds a kernel or takes an
engine lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref

from ..profiler import metrics as _metrics

__all__ = [
    "ProgramLedger", "WarmupManifest", "ledger", "reset",
    "encode_key", "decode_key",
]

_LEDGER = None
_LOCK = threading.Lock()
_PROVIDER_REGISTERED = False

#: flight-recorder budget for a single cold-start stall (seconds);
#: overridable via ``PADDLE_COLD_START_BUDGET_S``, <=0 disables.
DEFAULT_COLD_START_BUDGET_S = 30.0


def _budget_from_env():
    raw = os.environ.get("PADDLE_COLD_START_BUDGET_S")
    if raw is None:
        return DEFAULT_COLD_START_BUDGET_S
    try:
        v = float(raw)
    except ValueError:
        return DEFAULT_COLD_START_BUDGET_S
    return v if v > 0 else None


# ------------------------------------------------------------- key encoding
def encode_key(key):
    """Store keys are nested tuples of JSON scalars (str/int/float/bool).
    JSON has no tuple, so tuples encode as lists and :func:`decode_key`
    turns every list back into a tuple — exact round-trip because no
    store key contains a real list."""
    if isinstance(key, (tuple, list)):
        return [encode_key(k) for k in key]
    if key is None or isinstance(key, (str, int, float, bool)):
        return key
    raise TypeError(f"program key element {key!r} is not JSON-encodable")


def decode_key(obj):
    if isinstance(obj, list):
        return tuple(decode_key(o) for o in obj)
    return obj


def _fmt_key(key):
    """Human-oriented rendering for /statusz rows."""
    return repr(key)


# ------------------------------------------------------------------ entries
class ProgramEntry:
    """One minted program.  Plain record; mutated only under the ledger
    lock except ``analysis`` (write-once from resolve)."""

    __slots__ = ("key", "family", "replica", "device", "kind", "warm",
                 "build_s", "compile_s", "trace_id", "minted_at",
                 "analysis", "analysis_error", "_thunk", "_sid")

    def __init__(self, key, family, replica, device, kind, warm, sid):
        self.key = key
        self.family = family
        self.replica = replica
        self.device = device
        self.kind = kind            # "serving" | "generate" | "train_step"
        self.warm = warm            # True: found pre-traced (manifest/sibling)
        self.build_s = 0.0          # closure construction (host, cheap)
        self.compile_s = None       # observed first-dispatch stall (wall):
        #                             nvcc build + eager run + capture
        self.trace_id = None        # request trace id that paid the stall
        self.minted_at = time.time()
        self.analysis = None        # resolved jit_analysis_thunk dict
        self.analysis_error = None
        self._thunk = None          # lazy — never run on the scrape path
        self._sid = sid             # id(program_store) owning this key

    def row(self):
        r = {"key": _fmt_key(self.key), "family": self.family,
             "replica": self.replica, "device": self.device,
             "kind": self.kind,
             "cold": "warm" if self.warm else "cold",
             "build_s": round(self.build_s, 6),
             "compile_s": round(self.compile_s, 6)
             if self.compile_s is not None else None,
             "trace_id": self.trace_id}
        if self.analysis is not None:
            a = self.analysis
            r.update(trace_s=round(a.get("trace_s", 0.0), 6),
                     backend_compile_s=round(
                         a.get("backend_compile_s", 0.0), 6),
                     executable_bytes=a.get("executable_bytes"),
                     flops=a.get("flops"),
                     bytes_accessed=a.get("bytes_accessed"))
        elif self.analysis_error is not None:
            r["analysis_error"] = self.analysis_error
        elif self._thunk is not None:
            r["analysis"] = "pending"
        return r


# ----------------------------------------------------------- compile window
class _NoopWindow:
    """Warm dispatch: nothing to account, nothing to suppress."""

    __slots__ = ()

    def attach(self, program, args):
        pass

    def close(self, traced=False):
        pass


_NOOP_WINDOW = _NoopWindow()


class CompileWindow:
    """Open around a first dispatch that is expected to build, run and
    capture its program.

    While open it (a) marks ``engine._compiling`` so the serving
    watchdog/health/deadline paths know the stall is a compile, not a
    wedge, and (b) holds ``programs.compile_in_progress`` up — the
    ledger, not the engine, is now the authority on "a compile is in
    flight".  ``close(traced=...)`` releases both and, when the dispatch
    really traced, records the stall: ledger row + metrics + the
    per-request ``compile_s`` attribution for every handle that waited.
    """

    __slots__ = ("_led", "_key", "_family", "_replica", "_device", "_kind",
                 "_store", "_owner", "_handles", "_engine", "_program",
                 "_args", "_t0", "_closed")

    def __init__(self, led, key, family, replica, device, kind, store,
                 owner, handles, engine):
        self._led = led
        self._key = key
        self._family = family
        self._replica = replica
        self._device = device
        self._kind = kind
        self._store = store
        self._owner = owner
        self._handles = tuple(handles or ())
        self._engine = engine
        self._program = None
        self._args = None
        self._closed = False
        led._window_open(engine, replica)
        self._t0 = time.perf_counter()

    def attach(self, program, args):
        """The program for the lazy analysis thunk — held by weakref,
        run (counted) only when someone resolves."""
        self._program = program
        self._args = args

    def close(self, traced=True):
        if self._closed:
            return
        self._closed = True
        elapsed = time.perf_counter() - self._t0
        self._led._window_close(self._engine, self._replica)
        if traced:
            self._led.record_compile(
                self._key, elapsed, family=self._family,
                replica=self._replica, device=self._device, kind=self._kind,
                store=self._store, owner=self._owner, handles=self._handles,
                program=self._program, args=self._args)


# ------------------------------------------------------------------- ledger
class ProgramLedger:
    """Process-wide accounting of compiled-program mints.  See module
    docstring.  All methods are thread-safe; rows are keyed by
    ``(id(store), key)`` so two models with coincidentally equal keys
    don't alias."""

    def __init__(self, registry=None):
        reg = registry or _metrics.get_registry()
        self._m_compiled = reg.counter(
            "programs.compiled_total",
            "programs traced+compiled (one per cold mint)")
        self._m_compile_s = reg.counter(
            "programs.compile_seconds",
            "wall seconds spent in first-dispatch trace+compile stalls")
        self._m_stall_s = reg.counter(
            "programs.stall_seconds",
            "compile wall attributed to waiting requests (subset of "
            "programs.compile_seconds that a request actually paid)")
        self._m_inprog = reg.gauge(
            "programs.compile_in_progress",
            "compile windows currently open (a wedged compile shows "
            "here; a wedged scheduler does not)")
        self._lock = threading.RLock()
        self._entries = {}        # (sid, key) -> ProgramEntry
        self._owners = {}         # sid -> weakref(owner model) | None
        self._open_total = 0
        self._open_by_engine = {}   # id(engine) -> open-window count
        self._dumped = set()        # (sid, key) that already cost a dump
        self.budget_s = _budget_from_env()
        self.cold_dumps = 0

    # ------------------------------------------------------------- windows
    def compile_window(self, key, *, family, replica="0", device=None,
                       kind="serving", store=None, owner=None, handles=(),
                       engine=None, cold=True):
        """Open a compile window around a first dispatch.  ``cold=False``
        returns a shared no-op (the steady-state path pays one branch
        and an attribute load, nothing else)."""
        if not cold:
            return _NOOP_WINDOW
        return CompileWindow(self, key, family, replica, device, kind,
                             store, owner, handles, engine)

    def _window_open(self, engine, replica):
        with self._lock:
            self._open_total += 1
            if engine is not None:
                eid = id(engine)
                self._open_by_engine[eid] = \
                    self._open_by_engine.get(eid, 0) + 1
                engine._compiling = True
        self._m_inprog.inc(1, replica=str(replica))

    def _window_close(self, engine, replica):
        with self._lock:
            self._open_total = max(0, self._open_total - 1)
            if engine is not None:
                eid = id(engine)
                n = self._open_by_engine.get(eid, 0) - 1
                if n <= 0:
                    self._open_by_engine.pop(eid, None)
                    engine._compiling = False
                else:
                    self._open_by_engine[eid] = n
        self._m_inprog.inc(-1, replica=str(replica))

    def compiling(self, engine=None):
        """Is a compile window open (for ``engine``, or anywhere)?  The
        watchdog consults this instead of trusting a flag the engine
        forgot to clear: a capture in progress reads as slow, not stuck."""
        with self._lock:
            if engine is None:
                return self._open_total > 0
            return self._open_by_engine.get(id(engine), 0) > 0

    def in_progress(self):
        with self._lock:
            return self._open_total

    # -------------------------------------------------------------- records
    def record_mint(self, key, *, family, replica="0", device=None,
                    kind="serving", store=None, owner=None, build_s=0.0,
                    warm=False):
        """A program entered the store (or a TrainStep minted a variant).
        Creates the row; the compile window (or :meth:`record_compile`)
        fills in the observed stall."""
        sid = id(store) if store is not None else None
        with self._lock:
            ent = self._entries.get((sid, key))
            if ent is None:
                ent = ProgramEntry(key, family, str(replica), device, kind,
                                   warm, sid)
                self._entries[(sid, key)] = ent
                if sid is not None and sid not in self._owners:
                    try:
                        self._owners[sid] = weakref.ref(owner) \
                            if owner is not None else None
                    except TypeError:
                        self._owners[sid] = None
            ent.build_s += float(build_s)
        _ensure_provider()
        return ent

    def record_compile(self, key, stall_s, *, family, replica="0",
                       device=None, kind="serving", store=None, owner=None,
                       trace_id=None, handles=(), program=None, args=None):
        """An observed first-dispatch stall.  Fills the mint row (creates
        it if the mint site predates the ledger), bumps the counters,
        attributes the stall to every waiting request handle, arms the
        lazy analysis thunk, and fires the one-per-episode cold-start
        flight dump when the stall blows the budget."""
        stall_s = float(stall_s)
        ent = self.record_mint(key, family=family, replica=replica,
                               device=device, kind=kind, store=store,
                               owner=owner)
        paid = None
        for h in handles:
            if h is None:
                continue
            if paid is None:
                paid = getattr(h, "trace_id", None)
            # bill TTFT only to pre-first-token waiters: a stall AFTER a
            # request's first token delays its ITL, not its TTFT, and must
            # not make the decomposition sum past the observed TTFT
            if getattr(h, "first_token_at", None) is not None:
                continue
            try:
                h.compile_s += stall_s
            except AttributeError:
                continue
        if trace_id is None:
            trace_id = paid
        with self._lock:
            ent.warm = False
            ent.device = device if device is not None else ent.device
            ent.compile_s = (ent.compile_s or 0.0) + stall_s
            if trace_id is not None:
                ent.trace_id = trace_id
            if program is not None and ent._thunk is None:
                try:
                    from . import perf as _perf

                    ent._thunk = _perf.jit_analysis_thunk(program, args)
                except Exception:
                    ent._thunk = None
        labels = {"family": family, "replica": str(replica)}
        self._m_compiled.inc(1, **labels)
        self._m_compile_s.inc(stall_s, **labels)
        if any(h is not None for h in handles):
            self._m_stall_s.inc(stall_s, **labels)
        self._maybe_dump(ent, stall_s)
        return ent

    def _maybe_dump(self, ent, stall_s):
        budget = self.budget_s
        if budget is None or stall_s <= budget:
            return
        dkey = (ent._sid, ent.key)
        with self._lock:
            if dkey in self._dumped:
                return
            self._dumped.add(dkey)
            self.cold_dumps += 1
        try:
            from . import flight_recorder as _flight

            rec = _flight.get_flight_recorder()
            # "program_kind", not "kind": record(kind, name, **data) owns
            # the bare name
            extra = {"key": _fmt_key(ent.key), "family": ent.family,
                     "replica": ent.replica, "stall_s": round(stall_s, 3),
                     "budget_s": budget, "trace_id": ent.trace_id,
                     "program_kind": ent.kind}
            rec.record("programs", "cold_start", **extra)
            rec.dump("cold_start", extra=extra)
        except Exception:
            pass  # forensics must never take down serving

    # ------------------------------------------------------------ analysis
    def resolve_analysis(self):
        """Run every pending analysis thunk NOW (one eager step of the
        program's shapes per entry, counted — tooling/test path, never the
        scrape path).
        Failures are recorded on the row and not retried."""
        with self._lock:
            pending = [e for e in self._entries.values()
                       if e._thunk is not None and e.analysis is None
                       and e.analysis_error is None]
        n = 0
        for ent in pending:
            try:
                ent.analysis = ent._thunk()
                n += 1
            except Exception as exc:  # dead weakref, backend quirk, ...
                ent.analysis_error = f"{type(exc).__name__}: {exc}"
        return n

    # -------------------------------------------------------------- queries
    def rows(self, store=None, replica=None):
        """Ledger rows (dicts), most expensive compile first."""
        sid = id(store) if store is not None else None
        with self._lock:
            ents = [e for e in self._entries.values()
                    if (store is None or e._sid == sid)
                    and (replica is None or e.replica == str(replica))]
        ents.sort(key=lambda e: -(e.compile_s or 0.0))
        return [e.row() for e in ents]

    def entry(self, key, store=None):
        sid = id(store) if store is not None else None
        with self._lock:
            return self._entries.get((sid, key))

    def _live_store_size(self):
        """Total keys across live stores the ledger has seen.  Lazy
        import: _decode imports observability, not vice versa at module
        scope."""
        total = 0
        with self._lock:
            owners = list(self._owners.values())
        try:
            from ..text.models._decode import program_store
        except Exception:
            return None
        for ref in owners:
            model = ref() if ref is not None else None
            if model is None:
                continue
            store = program_store(model)
            if store:
                total += len(store)
        return total

    def statusz(self):
        """The /statusz ``programs`` section.  Plain-field reads only —
        bounded even while a compile window is open."""
        with self._lock:
            ents = list(self._entries.values())
            in_prog = self._open_total
            dumps = self.cold_dumps
        cold = [e for e in ents if not e.warm and e.compile_s is not None]
        total_s = sum(e.compile_s or 0.0 for e in ents)
        ents.sort(key=lambda e: -(e.compile_s or 0.0))
        return {
            "entries": len(ents),
            "store_size": self._live_store_size(),
            "cold_starts": len(cold),
            "compile_seconds_total": round(total_s, 6),
            "compile_in_progress": in_prog,
            "cold_start_budget_s": self.budget_s,
            "cold_start_dumps": dumps,
            "programs": [e.row() for e in ents],
        }

    def reset(self):
        """Tests: drop rows/episodes (metrics and provider survive)."""
        with self._lock:
            self._entries.clear()
            self._owners.clear()
            self._dumped.clear()
            self._open_by_engine.clear()
            self._open_total = 0
            self.cold_dumps = 0
            self.budget_s = _budget_from_env()


# ----------------------------------------------------------------- manifest
class WarmupManifest:
    """A program store's key set, serializable — capture on a warm
    process, replay on a cold one (``ServingEngine.warmup``) so the
    first real request never pays a build or a capture.  The schema
    string is the reference's, so a manifest saved by either package
    loads into the other.

    ``meta`` is free-form provenance (e.g. the engine stamps its adapter
    signature so a manifest captured for one model geometry is refused
    by another)."""

    SCHEMA = "paddle_tpu/warmup-manifest/v1"

    def __init__(self, keys=(), meta=None):
        self.keys = [tuple(k) if isinstance(k, (list, tuple)) else (k,)
                     for k in keys]
        self.meta = dict(meta or {})

    @classmethod
    def capture(cls, model, meta=None):
        """Snapshot the live store key set of ``model``.  Keys that are
        not JSON-encodable (exotic axes) are skipped and listed in
        ``meta['skipped']`` rather than poisoning the manifest."""
        from ..text.models._decode import program_store

        store = program_store(model)
        keys, skipped = [], []
        for k in (store or {}):
            try:
                encode_key(k)
            except TypeError:
                skipped.append(repr(k))
                continue
            keys.append(k)
        m = cls(keys, meta=meta)
        if skipped:
            m.meta["skipped"] = skipped
        return m

    # ---------------------------------------------------------------- json
    def to_json(self):
        return {"schema": self.SCHEMA,
                "keys": [encode_key(k) for k in self.keys],
                "meta": self.meta}

    @classmethod
    def from_json(cls, obj):
        if obj.get("schema") != cls.SCHEMA:
            raise ValueError(
                f"not a warmup manifest (schema={obj.get('schema')!r})")
        return cls([decode_key(k) for k in obj.get("keys", [])],
                   meta=obj.get("meta"))

    def save(self, path):
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path):
        with open(os.fspath(path)) as f:
            return cls.from_json(json.load(f))

    def __len__(self):
        return len(self.keys)

    def __iter__(self):
        return iter(self.keys)

    def __repr__(self):
        return f"WarmupManifest({len(self.keys)} keys)"


# ---------------------------------------------------------------- singleton
def ledger() -> ProgramLedger:
    global _LEDGER
    if _LEDGER is None:
        with _LOCK:
            if _LEDGER is None:
                _LEDGER = ProgramLedger()
    return _LEDGER


def _ensure_provider():
    """Register the /statusz ``programs`` section once, lazily on first
    mint — a process that never compiles never grows the key."""
    global _PROVIDER_REGISTERED
    if _PROVIDER_REGISTERED:
        return
    with _LOCK:
        if _PROVIDER_REGISTERED:
            return
        from . import telemetry as _telemetry

        _telemetry.add_status_provider(
            "programs", lambda: ledger().statusz())
        _PROVIDER_REGISTERED = True


def reset():
    """Tests: drop ledger rows and cold-start episodes (the singleton
    and its provider survive)."""
    if _LEDGER is not None:
        _LEDGER.reset()
