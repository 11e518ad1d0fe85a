"""paddle.profiler's ``Profiler`` context (counterpart of
``paddle_tpu/profiler/profiler.py``): CLOSED / READY / RECORD scheduler
states, ``on_trace_ready`` handlers, per-op summary tables, chrome-trace
export and ``load_profiler_result``.

Two sinks run side by side:

- **Device timeline**: ``torch.profiler.profile(activities=[CPU, CUDA])``
  (CUPTI on the card), opened and closed by the scheduler states exactly
  as the reference opens its ``jax.profiler`` trace; ``record_shapes``,
  ``profile_memory`` and ``with_flops`` pass through to it.  Under a
  replayed CUDA graph the host shows ``cudaGraphLaunch`` and the kernels
  still appear as device activity.  :meth:`Profiler.device_events` lists
  them; the export writes torch's chrome trace beside the host one.
- **Host event tree** (:mod:`.events`): ``RecordEvent`` regions plus one
  timer per ``torch.nn.Module`` call — forward pre / post hooks that are
  installed only while a Profiler records (the reference wires the same
  timers into ``nn.Layer.__call__``).  This feeds ``summary()``, the
  chrome-trace JSON export and ``load_profiler_result``.

Scheduler semantics (reference parity): a step whose state is
RECORD_AND_RETURN ends its trace cycle — the trace stops and
``on_trace_ready(prof)`` fires at that ``step()`` call, not at ``stop()``.
``make_scheduler(repeat=k)`` stops after k cycles.
"""

from __future__ import annotations

import enum
import json
import os
import tempfile
import threading
import time

from . import events as _events


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class SummaryView(enum.Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """reference: profiler.make_scheduler — maps step number to state.

    Cycle = ``closed`` CLOSED steps, ``ready`` READY (warmup) steps, then
    ``record`` RECORD steps whose last is RECORD_AND_RETURN.  ``repeat=0``
    cycles forever; ``repeat=k`` goes CLOSED after k full cycles.
    """
    period = max(closed + ready + record, 1)

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        s %= period
        if s < closed:
            return ProfilerState.CLOSED
        if s < closed + ready:
            return ProfilerState.READY
        if s == closed + ready + record - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """on_trace_ready handler: writes the host event tree as chrome-trace
    JSON into ``dir_name``, and torch's device trace of the same cycle
    beside it (``*_device_trace.json``)."""

    def handler(prof):
        prof._export_dir = dir_name
        name = f"{worker_name or 'host'}_chrome_trace.json"
        prof.export(os.path.join(dir_name, name), format="json")
        prof._export_device_trace(os.path.join(
            dir_name, f"{worker_name or 'host'}_device_trace.json"))

    handler._export_dir = dir_name  # Profiler aims the device trace here too
    return handler


def export_protobuf(dir_name, worker_name=None):
    """on_trace_ready handler, distinct from chrome tracing: writes the
    step-timing + op summary as ``*_profile_summary.json`` (the reference
    API spelling, with an artifact of its own; torch's device trace has no
    protobuf form)."""

    def handler(prof):
        prof._export_dir = dir_name
        os.makedirs(dir_name, exist_ok=True)
        name = f"{worker_name or 'host'}_profile_summary.json"
        path = os.path.join(dir_name, name)
        with open(path, "w") as f:
            json.dump(prof._summary_dict(), f, indent=1)
        prof._last_protobuf_path = path

    handler._export_dir = dir_name
    return handler


class Profiler:
    """Profiler context.  ``timer_only=True`` skips both sinks and keeps
    just the step timer (reference benchmark mode).  ``targets`` picks the
    device trace's activities (``ProfilerTarget.CPU`` / ``GPU``; default:
    the CPU, and CUDA where a card is present)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, emit_nvtx=False, device_trace=True):
        self._timer_only = timer_only
        # device_trace=False keeps only the host event tree (op table /
        # chrome export) without opening a torch.profiler trace — per-op
        # summaries with no unbounded device-trace session
        self._device_trace = device_trace
        self._targets = targets
        self._trace_kw = {"record_shapes": bool(record_shapes),
                          "profile_memory": bool(profile_memory),
                          "with_flops": bool(with_flops)}
        self._torch_prof = None        # the open torch.profiler session
        self._device_cycles = []       # finished sessions' key events
        self._last_torch_prof = None
        self._hooks = None             # module timer hook handles
        self._scheduler = scheduler if callable(scheduler) else None
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, record=hi - lo, repeat=1)
        self._on_ready = on_trace_ready
        # export handlers advertise their target dir — honor it from the
        # FIRST trace cycle, not only after on_trace_ready first fires
        self._export_dir = (getattr(on_trace_ready, "_export_dir", None)
                            or os.environ.get("PADDLE_PROFILER_DIR")
                            or os.path.join(tempfile.gettempdir(),
                                            "paddle_tpu_torch_trace"))
        self._step = 0
        self._tracing = False          # device (XPlane) trace open
        self._step_times = []          # (dt, num_samples) per finished step
        self._t0 = None
        self._origin = None            # perf_counter at start(), for trace ts
        self._cur_state = None
        self._collector = None         # host events for the CURRENT cycle
        self._all_roots = []           # host events across every cycle
        self._recorded_time = 0.0      # wall time spent in RECORD* steps
        self._cycles_delivered = 0
        self._last_protobuf_path = None

    # -------------------------------------------------------------- control
    def start(self):
        from time import perf_counter

        self._t0 = time.time()
        self._origin = perf_counter()
        self._clock_unix = self._t0  # anchor (t0 advances at step bounds)
        if self._timer_only:
            return self
        state = (self._scheduler(self._step) if self._scheduler is not None
                 else ProfilerState.RECORD)
        self._enter_state(state)
        return self

    def stop(self):
        # fold the trailing partial step into the denominator BEFORE any
        # on_trace_ready handler reads summaries (its events are already in
        # the collector, so Ratio (%) must see the matching time)
        if self._recording(self._cur_state) and self._t0 is not None:
            self._recorded_time += time.time() - self._t0
            self._t0 = time.time()
        self._end_host_collection()
        if self._tracing:
            self._stop_trace()
            self._deliver()
        elif self._scheduler is None and not self._timer_only \
                and self._cycles_delivered == 0:
            self._deliver()
        self._cur_state = None

    def _deliver(self):
        self._cycles_delivered += 1
        if self._on_ready is not None:
            self._on_ready(self)

    # ------------------------------------------------------ state transitions
    def _recording(self, state):
        return state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)

    def _enter_state(self, state):
        self._cur_state = state
        if self._recording(state):
            if not self._tracing:
                self._start_trace()
            if self._collector is None:
                self._collector = _events.EventCollector().start()
                self._install_module_timers()
        else:
            self._end_host_collection()
            if self._tracing:
                self._stop_trace()

    def _end_host_collection(self):
        if self._collector is not None:
            self._remove_module_timers()
            self._collector.stop()
            self._all_roots.extend(self._collector.roots)
            self._collector = None

    # the per-op timers: one host event per Module call, on the thread
    # that makes it, installed only while this Profiler records
    def _install_module_timers(self):
        import torch

        if self._hooks is not None:
            return
        local = threading.local()

        def pre(module, args):
            if _events._ACTIVE:
                stack = getattr(local, "stack", None)
                if stack is None:
                    stack = local.stack = []
                ev = _events.record(type(module).__name__)
                ev.__enter__()
                stack.append(ev)

        def post(module, args, out):
            stack = getattr(local, "stack", None)
            if stack:
                stack.pop().__exit__(None, None, None)

        reg = torch.nn.modules.module
        self._hooks = (reg.register_module_forward_pre_hook(pre),
                       reg.register_module_forward_hook(post))

    def _remove_module_timers(self):
        if self._hooks is not None:
            for h in self._hooks:
                h.remove()
            self._hooks = None

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity

        tg = self._targets
        if tg is None:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            return acts
        tg = tg if isinstance(tg, (list, tuple, set)) else [tg]
        acts = []
        if ProfilerTarget.CPU in tg:
            acts.append(ProfilerActivity.CPU)
        if ProfilerTarget.GPU in tg and torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts or [ProfilerActivity.CPU]

    def _start_trace(self):
        if not self._device_trace:
            self._tracing = False
            return
        import torch

        try:
            self._torch_prof = torch.profiler.profile(
                activities=self._activities(), **self._trace_kw)
            self._torch_prof.__enter__()
            self._tracing = True
        except Exception:
            self._torch_prof = None
            self._tracing = False

    def _stop_trace(self):
        prof, self._torch_prof = self._torch_prof, None
        self._tracing = False
        if prof is None:
            return
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            self._last_torch_prof = prof
            self._device_cycles.append(
                [(e.name, e.device_type, e.time_range.start,
                  e.time_range.end) for e in prof.events()])
        except Exception:
            pass

    def device_events(self, device_only=True):
        """``(name, start_us, end_us)`` of every event the device trace
        recorded across the finished cycles; ``device_only`` keeps the
        activity that ran on the card (kernels, copies), which a replayed
        CUDA graph still shows one by one."""
        out = []
        for cyc in self._device_cycles:
            for name, dev, t0, t1 in cyc:
                if device_only and "CUDA" not in str(dev):
                    continue
                out.append((name, t0, t1))
        return out

    def device_profile(self):
        """The last finished cycle's ``torch.profiler.profile`` session
        (None before one finished, or with ``device_trace=False``): its
        ``key_averages()`` sum the device time by kernel."""
        return self._last_torch_prof

    def _export_device_trace(self, path):
        """Write the last finished cycle's torch trace (chrome JSON)."""
        if self._last_torch_prof is None:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._last_torch_prof.export_chrome_trace(path)
        return path

    def step(self, num_samples=None):
        """Marks the end of the current step (reference semantics)."""
        now = time.time()
        if self._t0 is not None:
            dt = now - self._t0
            self._step_times.append((dt, num_samples))
            if self._recording(self._cur_state):
                self._recorded_time += dt
        self._t0 = now
        prev = self._cur_state
        self._step += 1
        if self._timer_only or self._scheduler is None:
            return
        if prev is ProfilerState.RECORD_AND_RETURN:
            # cycle boundary: close the trace and hand it over NOW (the
            # reference invokes on_trace_ready at this step, not at stop())
            self._end_host_collection()
            if self._tracing:
                self._stop_trace()
            self._deliver()
        self._enter_state(self._scheduler(self._step))

    # ------------------------------------------------------------- summaries
    def step_info(self, unit="samples"):
        if not self._step_times:
            return "no steps recorded"
        window = self._step_times[-10:]
        dts = [d for d, _ in window]
        avg = sum(dts) / len(dts)
        # throughput only over the steps that actually reported samples —
        # None-sample steps (eval, logging) must not dilute the denominator
        sampled = [(d, n) for d, n in window if n]
        s = f"avg step {avg * 1e3:.2f} ms"
        if sampled:
            ips = sum(n for _, n in sampled) / max(sum(d for d, _ in sampled),
                                                   1e-12)
            s += f", {ips:.1f} {unit}/sec"
        return s

    def _profiled_roots(self):
        # disjoint by construction: roots move into _all_roots only when
        # _end_host_collection discards the collector
        roots = list(self._all_roots)
        if self._collector is not None:
            roots.extend(self._collector.roots)
        return roots

    def _op_table(self):
        return _events.aggregate_durations(
            (ev.name, ev.duration)
            for root in self._profiled_roots()
            for ev in root.walk() if ev.t1 is not None)

    def _total_profiled_time(self):
        if self._recorded_time > 0:
            return self._recorded_time
        if self._t0 is not None:
            return max(time.time() - self._t0, 1e-12)
        return 1e-12

    _SORT_KEYS = {"total": "total", "cputotal": "total", "gputotal": "total",
                  "avg": "avg", "cpuavg": "avg", "gpuavg": "avg",
                  "max": "max", "cpumax": "max", "gpumax": "max",
                  "calls": "calls", "name": "name"}

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Print (and return) the per-op summary table.

        ``sorted_by``: 'total' (default) | 'avg' | 'max' | 'calls' | 'name'
        (reference SortedKeys spellings like 'CPUTotal' also accepted).
        """
        key = self._SORT_KEYS.get(str(sorted_by or "total").lower(), "total")
        unit_div = {"s": 1.0, "ms": 1e-3, "us": 1e-6}.get(time_unit, 1e-3)
        agg = self._op_table()
        total_time = self._total_profiled_time()
        rows = []
        for name, d in agg.items():
            rows.append({"name": name, "calls": d["calls"], "total": d["total"],
                         "avg": d["total"] / d["calls"], "max": d["max"],
                         "ratio": 100.0 * d["total"] / total_time})
        if key == "name":
            rows.sort(key=lambda r: r["name"])
        else:
            rows.sort(key=lambda r: r[key], reverse=True)

        widths = (max([len(r["name"]) for r in rows] + [20]) + 2, 8, 14, 14, 14, 10)
        cols = ("Name", "Calls", f"Total ({time_unit})", f"Avg ({time_unit})",
                f"Max ({time_unit})", "Ratio (%)")
        sep = "  ".join("-" * w for w in widths)
        lines = ["", self.step_info(), sep,
                 "  ".join(c.ljust(w) for c, w in zip(cols, widths)), sep]
        for r in rows:
            lines.append("  ".join([
                r["name"].ljust(widths[0]),
                str(r["calls"]).ljust(widths[1]),
                f"{r['total'] / unit_div:.3f}".ljust(widths[2]),
                f"{r['avg'] / unit_div:.3f}".ljust(widths[3]),
                f"{r['max'] / unit_div:.3f}".ljust(widths[4]),
                f"{r['ratio']:.2f}".ljust(widths[5]),
            ]))
        lines.append(sep)
        text = "\n".join(lines)
        print(text)
        return text

    def _summary_dict(self):
        return {
            "schema": "paddle_tpu.profiler.summary.v1",
            "steps": [{"dt": d, "num_samples": n} for d, n in self._step_times],
            "step_info": self.step_info(),
            "recorded_time": self._recorded_time,
            "ops": {name: d for name, d in self._op_table().items()},
        }

    # --------------------------------------------------------------- export
    def _trace_events(self):
        """Host event forest -> chrome-trace 'X' (complete) events."""
        origin = self._origin or 0.0
        out = []
        for root in self._profiled_roots():
            for ev in root.walk():
                if ev.t1 is None:
                    continue
                out.append({"name": ev.name, "ph": "X", "cat": "host",
                            "ts": (ev.t0 - origin) * 1e6,
                            "dur": ev.duration * 1e6,
                            "pid": _rank(), "tid": ev.tid})
        return out

    def export(self, path=None, format="json"):
        """Write the host event tree as chrome-trace JSON, the in-process,
        ``load_profiler_result``-loadable view (torch's device trace goes
        beside it through :func:`export_chrome_tracing`)."""
        if format not in ("json", "chrome"):
            raise ValueError(f"unsupported export format {format!r}")
        path = path or os.path.join(self._export_dir, "host_chrome_trace.json")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            # rank + wall-clock anchor: observability.merge_rank_traces
            # aligns per-rank exports on these (ts values are relative to
            # the perf_counter origin; unix_time is that origin's epoch)
            json.dump({"traceEvents": self._trace_events(),
                       "displayTimeUnit": "ms",
                       "metadata": {"summary": self._summary_dict(),
                                    "rank": _rank(),
                                    "clock": {
                                        "unix_time": getattr(
                                            self, "_clock_unix", self._t0),
                                        "perf_counter": self._origin}}}, f)
        return path

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ProfilerResult:
    """In-process view of an exported trace (load_profiler_result)."""

    def __init__(self, events, summary=None, path=None):
        self.events = events            # chrome-trace event dicts
        self._summary = summary or {}
        self.path = path

    @property
    def steps(self):
        return self._summary.get("steps", [])

    def op_summary(self):
        return _events.aggregate_durations(
            (ev["name"], ev.get("dur", 0.0) / 1e6)
            for ev in self.events if ev.get("ph") == "X")

    def summary(self, sorted_by="total"):
        key = Profiler._SORT_KEYS.get(str(sorted_by or "total").lower(), "total")
        rows = [{"name": n, "calls": d["calls"], "total": d["total"],
                 "avg": d["total"] / d["calls"], "max": d["max"]}
                for n, d in self.op_summary().items()]
        if key == "name":
            rows.sort(key=lambda r: r["name"])
        else:
            rows.sort(key=lambda r: r.get(key, 0), reverse=True)
        return rows

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "metadata": {"summary": self._summary}}, f)
        return path


def _rank():
    """This process's rank (0 outside a process group)."""
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() \
            and dist.is_initialized() else 0
    except Exception:
        return 0


def load_profiler_result(path):
    """Load a chrome-trace JSON written by :meth:`Profiler.export` (or a
    directory containing one) back into a :class:`ProfilerResult`."""
    if os.path.isdir(path):
        cands = sorted(f for f in os.listdir(path)
                       if f.endswith("chrome_trace.json"))
        if not cands:
            raise FileNotFoundError(
                f"no *chrome_trace.json under {path!r}; pass the JSON the "
                "profiler exported")
        path = os.path.join(path, cands[-1])
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):  # bare chrome-trace array form
        return ProfilerResult(data, path=path)
    return ProfilerResult(data.get("traceEvents", []),
                          summary=(data.get("metadata") or {}).get("summary"),
                          path=path)
