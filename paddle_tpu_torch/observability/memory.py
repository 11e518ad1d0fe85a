"""Device-memory ledger — WHO owns the card's bytes (counterpart of
``paddle_tpu/observability/memory.py``).

Every long-lived device allocation in the serving stack registers here
with an owner label from a fixed taxonomy:

- ``kv.pages`` — paged KV payload pools (the engine's pool tuple);
- ``kv.scales`` — the int8 engine's parallel float32 scale pools;
- ``model.params`` — model parameters + buffers (minus int8 weights);
- ``model.weights_int8`` — converted ``Int8Linear`` weight buffers;
- ``kv.spilled`` — the host spill tier (HOST bytes: ``device="host"``,
  excluded from device reconciliation);
- ``fault.memory_leak`` — the synthetic owner the ``memory.leak`` fault
  site grows (watchdog tests);
- ``untracked`` — the reconciliation remainder.

Registrations are *sources*, not snapshots: a zero-arg callable returning
the CURRENT tensors (or an int byte count), usually closed over a weakref
to the owning object so a dead engine's rows evict themselves on the next
read — the ledger never pins pools or params.

:meth:`MemoryLedger.report` reconciles the tracked set against the CUDA
caching allocator: ``untracked = torch.cuda.memory_allocated() - (the
registered bytes on the cards)``, an explicit ``owner="untracked"`` row
instead of silently missing bytes (the reference walks
``jax.live_arrays()``; the allocator counter is PyTorch's equivalent, and
reading it never syncs).  On the CPU there is no allocator counter, so a
process that has not initialized CUDA reports ``untracked`` as ``None``
and leaves the ``untracked`` gauges unset, rather than a made-up number.
Tensors shared between registrations are deduplicated for the tracked
total; each owner row still reports its full view.

Exported three ways: ``memory.device_bytes{owner=,replica=,device=}`` /
``memory.untracked_bytes`` / ``memory.total_bytes`` gauges in the port's
metrics registry, a ``memory`` section on ``/statusz`` (owner table
sorted by bytes, KV capacity math folded in from the registrations'
metadata), and :meth:`report` for programmatic use (tests, OOM
forensics).

On top of the ledger:

- :class:`MemoryWatchdog` — snapshots owner totals on a cadence and fires
  ONE flight-recorder dump per episode when an owner grows monotonically
  across N windows (``reason="memory_leak"``) or when the tracked total
  exceeds ``PADDLE_HBM_BUDGET_BYTES`` (``reason="hbm_budget"``).  The
  ``memory.leak`` fault site grows the synthetic ``fault.memory_leak``
  owner by 8 MiB per trip, so the alarm path runs without leaking
  anything real.
- OOM forensics — :func:`is_oom_error` recognizes a CUDA allocation
  failure (``torch.cuda.OutOfMemoryError``, or the ``RuntimeError`` text
  of one) and :func:`oom_dump` writes a flight record carrying the owner
  table; the serving scheduler calls both from its failure path.
- Admission pre-flight — :func:`hbm_budget_bytes` reads the budget env;
  ``ServingEngine.submit`` sheds with
  ``RequestRejectedError(reason="hbm_budget")`` when a request's
  projected pages would not fit the remaining budget (see the engine).
"""

from __future__ import annotations

import os
import threading
import weakref

import torch

from ..profiler import metrics as _metrics
from . import faults as _faults

#: synthetic growth per ``memory.leak`` fault trip (bytes)
FAULT_LEAK_STEP_BYTES = 8 * 1024 * 1024


def hbm_budget_bytes():
    """The configured HBM budget (``PADDLE_HBM_BUDGET_BYTES``), or None.
    Read dynamically — tests and operators flip it without rebuilds."""
    v = os.environ.get("PADDLE_HBM_BUDGET_BYTES")
    if not v:
        return None
    try:
        return int(float(v))
    except ValueError:
        return None  # malformed override must not kill admission


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted", "out of memory",
                "Out of memory", "OOM: ", "failed to allocate")


def is_oom_error(exc) -> bool:
    """True when an exception is a device allocation failure: a
    ``torch.cuda.OutOfMemoryError``, or an error whose text says so (a
    CUDA OOM raised as ``RuntimeError: CUDA error: out of memory``)."""
    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    s = f"{type(exc).__name__}: {exc}"
    return any(m in s for m in _OOM_MARKERS)


def oom_dump(exc, replica=None):
    """OOM forensics: one flight-recorder dump carrying the full owner
    table and every known per-program memory row (the graph pool's bytes
    of each captured program family) — the answer to 'who had the bytes
    when the allocator gave up'.  Never raises, never runs a program
    (pending perf costs stay pending)."""
    from . import flight_recorder as _flight
    from . import perf as _perf

    try:
        extra = {"error": f"{type(exc).__name__}: {exc}"[:4000],
                 "replica": replica,
                 "memory": ledger().statusz(),
                 "programs": [
                     {k: r.get(k) for k in
                      ("program", "calls", "argument_bytes", "output_bytes",
                       "temp_bytes", "peak_bytes")}
                     for r in _perf.snapshot(resolve=False)]}
    except Exception:
        extra = {"error": repr(exc)[:4000], "replica": replica}
    return _flight.get_flight_recorder().dump("oom", extra=extra)


class _Registration:
    """One owner's byte source.  ``source()`` returns the CURRENT arrays
    (list/tuple), an int byte count, or None once the owning object died
    (the ledger evicts the row)."""

    __slots__ = ("owner", "replica", "device", "source", "meta", "_ledger")

    def __init__(self, owner, source, replica, device, meta, led):
        self.owner = str(owner)
        self.replica = str(replica)
        self.device = device
        self.source = source
        self.meta = dict(meta) if meta else {}
        self._ledger = weakref.ref(led)

    def unregister(self):
        led = self._ledger()
        if led is not None:
            led.unregister(self)


def _array_device(arr):
    dev = getattr(arr, "device", None)
    return str(dev) if dev is not None else "device0"


def _cuda_allocated():
    """Bytes the CUDA caching allocator holds for live tensors, summed
    over the cards, or None when this process never initialized CUDA
    (the CPU has no allocator counter)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return sum(torch.cuda.memory_allocated(d)
               for d in range(torch.cuda.device_count()))


class MemoryLedger:
    """The process-wide owner table (one per process — :func:`ledger`).
    Registration is cheap (a locked list append); all byte math happens
    at read time from the sources, so rows are never stale."""

    def __init__(self, registry=None):
        reg = registry if registry is not None else _metrics.get_registry()
        self._regs: list[_Registration] = []
        self._lock = threading.Lock()
        self._m_bytes = reg.gauge(
            "memory.device_bytes",
            "resident device bytes by owner (ledger view; owner="
            "'untracked' is the allocator remainder)")
        self._m_untracked = reg.gauge(
            "memory.untracked_bytes",
            "CUDA-allocated bytes no ledger registration claims")
        self._m_total = reg.gauge(
            "memory.total_bytes",
            "tracked (deduplicated) + untracked device bytes")

    # ---------------------------------------------------------- registration
    def register(self, owner, source=None, *, nbytes=None, replica="0",
                 device=None, meta=None) -> _Registration:
        """Register an owner.  ``source`` is a zero-arg callable returning
        the current arrays / an int / None-when-dead; ``nbytes`` registers
        a fixed count instead.  ``device="host"`` rows are bookkeeping
        only — excluded from the allocator reconciliation."""
        if source is None:
            if nbytes is None:
                raise ValueError("register needs source= or nbytes=")
            fixed = int(nbytes)
            source = lambda: fixed  # noqa: E731
        reg = _Registration(owner, source, replica, device, meta, self)
        with self._lock:
            self._regs.append(reg)
        _ensure_provider()
        return reg

    def unregister(self, reg):
        with self._lock:
            try:
                self._regs.remove(reg)
            except ValueError:
                pass

    def reset(self):
        """Tests: drop every registration (the gauges' already-rendered
        series stay, like any labelled metric's)."""
        with self._lock:
            self._regs.clear()

    # --------------------------------------------------------------- reading
    def _rows(self):
        """Resolve every source: (registration, bytes, arrays) rows, dead
        registrations evicted.  Reads tensor metadata only — never takes
        any engine lock."""
        with self._lock:
            regs = list(self._regs)
        rows, dead = [], []
        for reg in regs:
            try:
                val = reg.source()
            except Exception:
                val = None
            if val is None:
                dead.append(reg)
                continue
            if isinstance(val, (int, float)):
                rows.append((reg, int(val), ()))
            else:
                arrs = tuple(val)
                rows.append((reg, sum(int(a.nbytes) for a in arrs), arrs))
        if dead:
            with self._lock:
                for reg in dead:
                    try:
                        self._regs.remove(reg)
                    except ValueError:
                        pass
        return rows

    def owner_rows(self, replica=None):
        """Owner table WITHOUT the allocator reconciliation.  Optionally
        filtered by replica."""
        out = []
        for reg, nbytes, arrs in self._rows():
            if replica is not None and reg.replica != str(replica):
                continue
            dev = reg.device or (_array_device(arrs[0]) if arrs else "device0")
            row = {"owner": reg.owner, "replica": reg.replica, "device": dev,
                   "bytes": nbytes, "arrays": len(arrs)}
            if reg.meta:
                row["meta"] = dict(reg.meta)
            out.append(row)
        out.sort(key=lambda r: -r["bytes"])
        return out

    def kv_pool_bytes(self):
        """Total bytes under the KV owners (payload + scale pools) — the
        denominator perf's chunk-the-prefill hint compares peak temp
        bytes against."""
        return sum(b for reg, b, _ in self._rows()
                   if reg.owner in ("kv.pages", "kv.scales"))

    def owner_totals(self):
        """{owner: bytes} summed across replicas/devices (the watchdog's
        leak-detection unit)."""
        totals = {}
        for reg, nbytes, _ in self._rows():
            totals[reg.owner] = totals.get(reg.owner, 0) + nbytes
        return totals

    def report(self):
        """The reconciled ledger: owner rows (sorted by bytes, an explicit
        ``untracked`` row last), the deduplicated tracked total, and the
        comparison with the CUDA allocator's live bytes (``None`` where
        CUDA is not in use).  Refreshes the ``memory.*`` gauges.  Reads
        tensor metadata and the allocator counter only — no device sync,
        no engine lock — so it is safe from a telemetry scrape."""
        rows = self._rows()
        tracked_ids = set()
        tracked_bytes = 0          # deduplicated across registrations
        tracked_cuda = 0           # the part the allocator counter covers
        out_rows = []
        for reg, nbytes, arrs in rows:
            for a in arrs:
                if id(a) not in tracked_ids:
                    tracked_ids.add(id(a))
                    if reg.device != "host":
                        tracked_bytes += int(a.nbytes)
                        if a.device.type == "cuda":
                            tracked_cuda += int(a.nbytes)
            if not arrs and reg.device != "host":
                tracked_bytes += nbytes   # synthetic/int rows: no dedup key
            dev = reg.device or (_array_device(arrs[0]) if arrs else "device0")
            row = {"owner": reg.owner, "replica": reg.replica, "device": dev,
                   "bytes": nbytes, "arrays": len(arrs)}
            if reg.meta:
                row["meta"] = dict(reg.meta)
            out_rows.append(row)
            self._m_bytes.set(float(nbytes), owner=reg.owner,
                              replica=reg.replica, device=dev)
        live_bytes = _cuda_allocated()
        untracked = None if live_bytes is None else live_bytes - tracked_cuda
        out_rows.sort(key=lambda r: -r["bytes"])
        out_rows.append({"owner": "untracked", "replica": "-",
                         "device": "-", "bytes": untracked, "arrays": None})
        if untracked is not None:
            self._m_bytes.set(float(untracked), owner="untracked",
                              replica="-", device="-")
            self._m_untracked.set(float(untracked))
        total = tracked_bytes + (untracked or 0)
        self._m_total.set(float(total))
        return {
            "owners": out_rows,
            "tracked_bytes": tracked_bytes,
            "untracked_bytes": untracked,
            "live_bytes": live_bytes,
            "total_bytes": total,
            "untracked_frac": untracked / live_bytes if live_bytes else None,
        }

    def statusz(self):
        """/statusz ``memory`` section: the reconciled owner table, the
        budget, and the KV capacity math folded in from the pool
        registrations' metadata (bytes/page, pool pages, max resident
        slots at the engine's max_model_len — the
        ``BlockManager.max_resident_sequences`` numbers)."""
        rep = self.report()
        budget = hbm_budget_bytes()
        capacity = []
        for row in rep["owners"]:
            meta = row.get("meta") or {}
            if meta.get("kind") != "kv":
                continue
            cap = {
                "replica": row["replica"],
                "bytes_per_page": meta.get("bytes_per_page"),
                "page_size": meta.get("page_size"),
                "num_pages": meta.get("num_pages"),
                "max_model_len": meta.get("max_model_len"),
                "max_resident_slots": meta.get("max_resident_slots"),
            }
            capacity.append(cap)
        rep["budget_bytes"] = budget
        if budget:
            rep["budget_used_frac"] = rep["total_bytes"] / budget
        rep["kv_capacity"] = capacity
        return rep


# ------------------------------------------------------------ process state
_LEDGER: MemoryLedger | None = None
_LOCK = threading.Lock()
_PROVIDER_REGISTERED = False

# synthetic fault.memory_leak owner state (the ``memory.leak`` site)
_fault_leak_bytes = 0
_fault_leak_trips_seen = 0
_fault_leak_registered = False


def ledger() -> MemoryLedger:
    global _LEDGER
    if _LEDGER is None:
        with _LOCK:
            if _LEDGER is None:
                _LEDGER = MemoryLedger()
    return _LEDGER


def _ensure_provider():
    """Register the /statusz ``memory`` section once, lazily on first
    registration — a process that never registers never grows the key.
    The provider renders :meth:`MemoryLedger.statusz` — tensor metadata
    only, no engine locks."""
    global _PROVIDER_REGISTERED
    if _PROVIDER_REGISTERED:
        return
    with _LOCK:
        if _PROVIDER_REGISTERED:
            return
        from . import telemetry as _telemetry

        _telemetry.add_status_provider("memory", lambda: ledger().statusz())
        _PROVIDER_REGISTERED = True


def reset():
    """Tests: drop registrations, watchdog episodes and synthetic fault
    bytes (the ledger object and its provider survive)."""
    global _fault_leak_bytes, _fault_leak_trips_seen
    if _LEDGER is not None:
        _LEDGER.reset()
    with _LOCK:
        _fault_leak_bytes = 0
        _fault_leak_trips_seen = 0
        # a reset ledger dropped the synthetic row with everything else;
        # the next trip re-registers it
        global _fault_leak_registered
        _fault_leak_registered = False


def _tick_fault_leak():
    """The ``memory.leak`` fault site: each armed trip grows the synthetic
    ``fault.memory_leak`` owner by :data:`FAULT_LEAK_STEP_BYTES`, so the
    watchdog's whole alarm path runs against a deterministic 'leak'
    without allocating anything."""
    global _fault_leak_bytes, _fault_leak_trips_seen, _fault_leak_registered
    _faults.maybe("memory.leak")
    trips = _faults.trip_count("memory.leak")
    with _LOCK:
        if trips < _fault_leak_trips_seen:   # faults.clear() reset the site
            _fault_leak_trips_seen = 0
        new = trips - _fault_leak_trips_seen
        if new > 0:
            _fault_leak_trips_seen = trips
            _fault_leak_bytes += new * FAULT_LEAK_STEP_BYTES
        grown = _fault_leak_bytes
        need_reg = grown and not _fault_leak_registered
        if need_reg:
            _fault_leak_registered = True
    if need_reg:
        ledger().register("fault.memory_leak",
                          lambda: _fault_leak_bytes or None,
                          replica="-", meta={"kind": "fault"})
    return grown


class MemoryWatchdog:
    """Leak + budget watchdog over the ledger: snapshot owner totals each
    tick; an owner that grew on ``windows`` CONSECUTIVE ticks fires one
    flight-recorder dump per episode (``reason="memory_leak"``, the full
    owner table attached, the leaking owner named); a reconciled total
    over ``PADDLE_HBM_BUDGET_BYTES`` fires one ``reason="hbm_budget"``
    dump per excursion.  ``tick()`` is callable directly (tests, cron);
    ``start()`` runs it on a daemon cadence."""

    def __init__(self, led=None, interval_s=5.0, windows=3,
                 min_growth_bytes=1):
        self._ledger = led if led is not None else ledger()
        self.interval_s = float(interval_s)
        self.windows = int(windows)
        self.min_growth_bytes = int(min_growth_bytes)
        self._last: dict[str, int] = {}
        self._streak: dict[str, int] = {}
        self._fired: set[str] = set()
        self._budget_fired = False
        self._thread = None
        self._stop = threading.Event()
        self._m_alerts = _metrics.counter(
            "memory.leak_alerts",
            "watchdog leak/budget episodes that dumped a flight record")

    # ------------------------------------------------------------------ tick
    def tick(self):
        """One watchdog pass; returns the flight-dump paths it fired
        (usually empty)."""
        from . import flight_recorder as _flight

        _tick_fault_leak()
        totals = self._ledger.owner_totals()
        fired = []
        for owner, nbytes in totals.items():
            prev = self._last.get(owner)
            if prev is None:
                continue  # first sighting: a baseline, not growth
            if nbytes >= prev + self.min_growth_bytes:
                self._streak[owner] = self._streak.get(owner, 0) + 1
            else:
                self._streak[owner] = 0
                self._fired.discard(owner)   # episode over: re-arm
        for owner in list(self._streak):
            if self._streak.get(owner, 0) >= self.windows \
                    and owner not in self._fired:
                self._fired.add(owner)
                self._m_alerts.inc()
                path = _flight.get_flight_recorder().dump(
                    "memory_leak", extra={
                        "leaking_owner": owner,
                        "grew_windows": self._streak[owner],
                        "owner_bytes": totals.get(owner),
                        "owners": self._ledger.owner_rows(),
                    })
                if path:
                    fired.append(path)
        self._last = dict(totals)
        budget = hbm_budget_bytes()
        if budget:
            total = sum(totals.values())
            if total > budget and not self._budget_fired:
                self._budget_fired = True
                self._m_alerts.inc()
                path = _flight.get_flight_recorder().dump(
                    "hbm_budget", extra={
                        "budget_bytes": budget,
                        "total_bytes": total,
                        "owners": self._ledger.owner_rows(),
                    })
                if path:
                    fired.append(path)
            elif total <= budget:
                self._budget_fired = False
        return fired

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the watchdog must never kill its host

        self._thread = threading.Thread(
            target=loop, name="paddle-memory-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
