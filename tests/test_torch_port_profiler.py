"""PyTorch port, the ``Profiler`` context on the CPU against the JAX
package's ``profiler/profiler.py``: ``make_scheduler`` gives the
reference's state sequence for a grid of ``(closed, ready, record,
repeat, skip_first)``; ``on_trace_ready`` fires at the same steps for the
same scheduler; ``step_info`` and the ``summary`` table list the same
events (names, call counts, order by name) for the same ``RecordEvent``
tree; ``export`` then ``load_profiler_result`` round-trips; ``timer_only``
keeps only the step timer; ``device_trace=False`` opens no
``torch.profiler`` session while the host tree still records; the
per-``Module`` timers exist only while recording; the device trace of a
recording cycle holds the CPU ops it ran.  Every comparison here is
exact (times are not compared)."""

import json
import os

import pytest
import torch

from paddle_tpu.profiler import profiler as jprofiler
from paddle_tpu.profiler.events import RecordEvent as JRecordEvent
from paddle_tpu_torch.profiler import (Profiler, ProfilerState, RecordEvent,
                                       load_profiler_result, make_scheduler)
from paddle_tpu_torch.profiler import profiler as tprofiler

GRID = [(c, r, rec, rep, sk)
        for c in (0, 1, 2) for r in (0, 1) for rec in (1, 2, 3)
        for rep in (0, 1, 2) for sk in (0, 1, 3)]


@pytest.mark.parametrize("closed,ready,record,repeat,skip_first", GRID)
def test_make_scheduler_equals_the_reference(closed, ready, record, repeat,
                                            skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    got = [make_scheduler(**kw)(s).name for s in range(40)]
    want = [jprofiler.make_scheduler(**kw)(s).name for s in range(40)]
    assert got == want


def _fire_steps(mod, sched, n=12, **kw):
    fired = []
    prof = mod.Profiler(scheduler=sched, device_trace=False,
                        on_trace_ready=lambda p: fired.append(p._step), **kw)
    prof.start()
    for _ in range(n):
        prof.step()
    prof.stop()
    return fired


@pytest.mark.parametrize("sched", [
    (2, 5), dict(closed=1, ready=1, record=2, repeat=2),
    dict(closed=0, ready=0, record=1, repeat=0, skip_first=2),
    dict(closed=2, ready=0, record=3, repeat=1, skip_first=1), None])
def test_on_trace_ready_fires_at_the_same_steps(sched):
    def build(mod):
        if isinstance(sched, dict):
            return mod.make_scheduler(**sched)
        return sched
    got = _fire_steps(tprofiler, build(tprofiler))
    want = _fire_steps(jprofiler, build(jprofiler))
    assert got == want


def _tree(mod_event):
    """The same RecordEvent tree, three steps."""
    def run(prof):
        for i in range(3):
            with mod_event("step"):
                with mod_event("forward"):
                    with mod_event("attention"):
                        pass
                    with mod_event("mlp"):
                        pass
                with mod_event("sample"):
                    pass
            prof.step(num_samples=8)
    return run


def _rows(prof):
    return sorted((r["name"], r["calls"]) for r in _table(prof))


def _table(prof):
    agg = prof._op_table()
    return [{"name": n, "calls": d["calls"]} for n, d in agg.items()]


def test_step_info_and_summary_rows_equal_the_reference(capsys):
    out = {}
    for name, mod, ev in (("torch", tprofiler, RecordEvent),
                          ("jax", jprofiler, JRecordEvent)):
        prof = mod.Profiler(device_trace=False)
        prof.start()
        _tree(ev)(prof)
        prof.stop()
        text = prof.summary(sorted_by="name")
        lines = [ln.split()[:2] for ln in text.splitlines()[5:-1]]
        info = prof.step_info()
        out[name] = (_rows(prof), lines, info.split(",")[1:],
                     len(prof._step_times))
    assert out["torch"][0] == out["jax"][0] == [
        ("attention", 3), ("forward", 3), ("mlp", 3), ("sample", 3),
        ("step", 3)]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][3] == out["jax"][3] == 3
    assert "samples/sec" in out["torch"][2][0]


def test_export_then_load_round_trips(tmp_path):
    prof = Profiler(device_trace=False)
    prof.start()
    _tree(RecordEvent)(prof)
    prof.stop()
    path = prof.export(str(tmp_path / "host_chrome_trace.json"))
    res = load_profiler_result(path)
    assert sorted((r["name"], r["calls"]) for r in res.summary("name")) \
        == _rows(prof)
    assert len(res.steps) == 3
    again = load_profiler_result(str(tmp_path))        # the directory form
    assert [e["name"] for e in again.events] == [e["name"]
                                                 for e in res.events]
    doc = json.load(open(path))
    assert doc["metadata"]["rank"] == 0
    assert doc["metadata"]["summary"]["schema"] == \
        "paddle_tpu.profiler.summary.v1"
    with pytest.raises(FileNotFoundError):
        load_profiler_result(str(tmp_path / "nothing"))
    os.makedirs(tmp_path / "nothing")
    with pytest.raises(FileNotFoundError):
        load_profiler_result(str(tmp_path / "nothing"))


def test_timer_only_keeps_just_the_step_timer():
    prof = Profiler(timer_only=True)
    with prof:
        for _ in range(4):
            with RecordEvent("x"):
                pass
            prof.step(num_samples=2)
    assert len(prof._step_times) == 4
    assert _rows(prof) == []
    assert prof._torch_prof is None and prof._last_torch_prof is None


def test_device_trace_off_records_the_host_tree_only():
    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU())
    prof = Profiler(device_trace=False)
    with prof:
        with RecordEvent("step"):
            m(torch.randn(2, 4))
    assert prof._last_torch_prof is None and not prof.device_events()
    rows = dict(_rows(prof))
    # the per-Module timers: one event per Module call
    assert rows == {"step": 1, "Sequential": 1, "Linear": 1, "ReLU": 1}
    # ... installed only while recording
    prof2 = Profiler(device_trace=False)
    m(torch.randn(2, 4))
    assert prof2._hooks is None and prof._hooks is None


def test_device_trace_records_the_cycle(tmp_path):
    m = torch.nn.Linear(8, 8)
    out = {}
    handler = tprofiler.export_chrome_tracing(str(tmp_path))

    def ready(p):
        out["events"] = p.device_events(device_only=False)
        handler(p)

    prof = Profiler(scheduler=(1, 3), on_trace_ready=ready,
                    record_shapes=True)
    prof.start()
    for _ in range(4):
        m(torch.randn(2, 8))
        prof.step()
    prof.stop()
    names = {n for n, _, _ in out["events"]}
    assert "aten::linear" in names or "aten::addmm" in names
    assert os.path.exists(tmp_path / "host_chrome_trace.json")
    assert os.path.exists(tmp_path / "host_device_trace.json")
    assert prof._cur_state is None
    assert ProfilerState.RECORD_AND_RETURN.name == "RECORD_AND_RETURN"
