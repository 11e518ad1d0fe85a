"""Live telemetry endpoint: an opt-in stdlib HTTP thread per process
(counterpart of ``paddle_tpu/observability/telemetry.py``).

- ``/metrics`` — the port's metrics registry in Prometheus text exposition
  format (``MetricsRegistry.to_prometheus``);
- ``/healthz`` — liveness: ``{"status": "ok", "uptime_s": …, "rank": …}``,
  folded with every registered health provider (worst gating state wins;
  ``draining`` / ``stopped`` / ``error`` answer 503);
- ``/statusz`` — the human page: engine occupancy / queue depth / slot
  table / page-pool utilization (via registered status providers, one
  ``serving/<replica>`` section per engine), in-flight spans, the flight
  recorder, armed faults, and the ``memory`` (ledger), ``numerics``,
  ``perf_programs`` (the per-program roofline table) and ``programs``
  (the program ledger: per-key compile seconds, cold / warm provenance,
  the trace id that paid each stall, and whether a compile window is open
  right now — a capture in progress against a wedged scheduler) sections
  once those modules are in use.

Opt-in spellings: ``observability.serve(port)`` from code, or
``ServingEngine(telemetry_port=...)`` / ``PADDLE_TELEMETRY_PORT`` and let
``ServingEngine.start`` wire it (port 0 binds an ephemeral port, reported
on ``TelemetryServer.port``).  Pure stdlib ``http.server`` on a daemon
thread — no new dependencies, no effect on the hot path.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import perf_counter as _pc, time as _wall

from ..profiler import metrics as _metrics
from . import faults as _faults
from . import flight_recorder as _flight
from . import tracing as _tracing

_SERVER: "TelemetryServer | None" = None
_LOCK = threading.Lock()
# providers registered before/independently of any server instance so the
# engine can register itself whether or not serve() already ran
_PROVIDERS: dict[str, object] = {}
# health providers: fn() -> {"state": "healthy|degraded|draining|...",
# "reasons": [...]}.  /healthz aggregates the WORST component state so a
# load balancer sees one answer (and a 503 once anything is draining).
_HEALTH_PROVIDERS: dict[str, object] = {}
# components reported on /healthz but excluded from the worst-state fold
# (e.g. individual cluster replicas — the cluster component gates instead)
_HEALTH_NON_GATING: set[str] = set()
_HEALTH_ORDER = {"ok": 0, "healthy": 0, "degraded": 1, "stopped": 2,
                 "draining": 2, "error": 3}


def add_status_provider(name, fn):
    """Register ``fn() -> json-able`` under ``/statusz``'s ``name`` key."""
    _PROVIDERS[name] = fn


def remove_status_provider(name):
    _PROVIDERS.pop(name, None)


def add_health_provider(name, fn, gating=True):
    """Register ``fn() -> {"state": ..., "reasons": [...]}`` folded into
    ``/healthz`` (worst state wins; draining/error answer 503 so load
    balancers stop routing here).

    ``gating=False`` components are still reported in the /healthz body
    but excluded from the worst-state fold: a cluster's replicas register
    non-gating and the cluster's OWN any-replica-routable component gates
    instead — one dead replica of N must not 503 the whole process."""
    _HEALTH_PROVIDERS[name] = fn
    if gating:
        _HEALTH_NON_GATING.discard(name)
    else:
        _HEALTH_NON_GATING.add(name)


def remove_health_provider(name):
    _HEALTH_PROVIDERS.pop(name, None)
    _HEALTH_NON_GATING.discard(name)


def remove_providers_if_owner(name, status_fn=None, health_fn=None):
    """Unregister ``name``'s status/health providers only while they are
    still the given functions: registration is keyed, so a newer engine or
    cluster may own the key by now and its providers must survive an older
    owner's stop()."""
    if status_fn is not None and _PROVIDERS.get(name) is status_fn:
        remove_status_provider(name)
    if health_fn is not None and _HEALTH_PROVIDERS.get(name) is health_fn:
        remove_health_provider(name)


class TelemetryServer:
    """One HTTP thread serving /metrics, /healthz and /statusz."""

    def __init__(self, port=0, host="127.0.0.1", registry=None):
        self.host = host
        self._requested_port = int(port)
        self.port = None  # actual bound port after start()
        self._registry = registry
        self._httpd = None
        self._thread = None
        self._t0 = None

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._httpd is not None:
            return self
        server = self
        # self-observation: every scrape's render+send wall time, by path.
        # Providers never hold engine or scheduler locks across a render —
        # this histogram is how an operator checks that scrapes stay
        # bounded while the engine is mid-decode.
        self._m_scrape = _metrics.histogram(
            "telemetry.scrape_seconds",
            "telemetry endpoint render+send wall time, by path")

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def _send(self, code, body, ctype):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                t0 = _pc()
                try:
                    if path == "/metrics":
                        self._send(200, server._metrics_text(),
                                   "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        code, doc = server._healthz()
                        self._send(code, json.dumps(doc),
                                   "application/json")
                    elif path == "/statusz":
                        self._send(200,
                                   json.dumps(server._statusz(),
                                              default=repr),
                                   "application/json")
                    else:
                        self._send(404, json.dumps(
                            {"error": "not found", "endpoints":
                             ["/metrics", "/healthz", "/statusz"]}),
                            "application/json")
                except Exception as e:  # a scrape must never kill the thread
                    try:
                        self._send(500, json.dumps({"error": repr(e)}),
                                   "application/json")
                    except Exception:
                        pass
                finally:
                    try:
                        # bounded label set: arbitrary 404 paths (a port
                        # scanner on a non-loopback bind) must not mint
                        # permanent series in the process-wide registry
                        known = path if path in ("/metrics", "/healthz",
                                                 "/statusz") else "other"
                        server._m_scrape.observe(_pc() - t0, path=known)
                    except Exception:
                        pass  # self-observation must not break a scrape

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._t0 = _wall()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="paddle-telemetry",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self):
        return f"http://{self.host}:{self.port}" if self.port else None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- content
    def _metrics_text(self):
        reg = self._registry or _metrics.get_registry()
        return reg.to_prometheus()

    def _healthz(self):
        """(http_code, doc): worst registered component state wins.  No
        components = plain liveness (status "ok")."""
        doc = {"status": "ok", "uptime_s": _wall() - (self._t0 or _wall()),
               "rank": _tracing.safe_rank(), "pid": os.getpid()}
        worst = "ok"
        components = {}
        for name, fn in list(_HEALTH_PROVIDERS.items()):
            try:
                st = fn()
            except Exception as e:
                st = {"state": "error", "reasons": [repr(e)]}
            if not isinstance(st, dict):
                st = {"state": str(st), "reasons": []}
            components[name] = st
            if name in _HEALTH_NON_GATING:
                st["gating"] = False
                continue
            s = str(st.get("state", "ok"))
            if _HEALTH_ORDER.get(s, 1) > _HEALTH_ORDER.get(worst, 0):
                worst = s
        if components:
            doc["components"] = components
            doc["status"] = "ok" if worst in ("ok", "healthy") else worst
        code = 503 if _HEALTH_ORDER.get(doc["status"], 0) >= 2 else 200
        return code, doc

    def _statusz(self):
        rec = _flight.get_flight_recorder()
        out = {
            "time": _wall(),
            "rank": _tracing.safe_rank(),
            "pid": os.getpid(),
            "tracing_active": _tracing.enabled(),
            "in_flight_spans": _tracing.open_spans(),
            "last_flight_record": rec.last_dump_path,
            "flight_recorder_armed": _flight.enabled(),
            # chaos visibility: which fault hooks are armed RIGHT NOW (an
            # operator staring at a wedged /statusz should immediately see
            # a forgotten fault plan)
            "faults": _faults.describe(),
            # the reference's key, with the value it has while no
            # collective watchdog runs: the port has no collectives yet
            "collective_watchdog": None,
        }
        for name, fn in list(_PROVIDERS.items()):
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": repr(e)}
        return out


def serve(port=None, host=None, registry=None) -> TelemetryServer:
    """Start (or return) the process telemetry server.  ``port=None`` reads
    ``PADDLE_TELEMETRY_PORT``; port 0 binds an ephemeral port.
    ``host=None`` reads ``PADDLE_TELEMETRY_HOST`` (default loopback —
    bind ``0.0.0.0`` explicitly to let a remote Prometheus scrape this
    process).  One server per process: a second call returns the existing
    one, with a loud warning if it asked for a different fixed port
    (nothing listens there — scrape the running server's ``port``)."""
    global _SERVER
    with _LOCK:
        if host is None:
            host = os.environ.get("PADDLE_TELEMETRY_HOST", "127.0.0.1")
        if _SERVER is not None:
            if port not in (None, 0, _SERVER.port):
                import warnings

                warnings.warn(
                    f"observability.serve({port}): telemetry server already "
                    f"listening on port {_SERVER.port}; the requested port "
                    "is NOT bound (one server per process) — scrape "
                    f"{_SERVER.url}", stacklevel=2)
            return _SERVER
        if port is None:
            port = int(os.environ.get("PADDLE_TELEMETRY_PORT", "0"))
        _SERVER = TelemetryServer(port=port, host=host,
                                  registry=registry).start()
        return _SERVER


def get_server():
    return _SERVER


def shutdown():
    global _SERVER
    with _LOCK:
        if _SERVER is not None:
            _SERVER.stop()
            _SERVER = None
