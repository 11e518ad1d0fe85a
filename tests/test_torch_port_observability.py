"""PyTorch port, the serving engine's observability layer, on the CPU
against the JAX package: paddle_tpu_torch's metrics registry, events,
tracing, flight recorder, watchdog, memory ledger, numerics stream and
SLO gauges, and ServingEngine's ``serving.*`` families, spans and HBM
pre-flight.

- The registry: the same operations on a fresh JAX ``MetricsRegistry``
  and a fresh port one give byte-equal Prometheus text and equal JSONL
  rows (timestamps aside); ``load_jsonl`` round-trips.
- The engine's families: the same traffic (admission held at a
  ``serving.scheduler_wedge@<replica>`` fault, so both engines admit in
  one pass) through a JAX and a port engine gives the same ``serving.*``
  families with a series for the replica, equal counters and equal
  histogram observation counts — plain with a restart and a shed, the
  numeric guard with a NaN lane, speculative, chunked, radix + spill,
  QoS tiers with a preemption, int8 pools and weights.  Exceptions, each
  a decision of the port: the ``*_traces`` counters (JAX program traces;
  the port compiles none, so they stay 0) and ``ttft_cold_seconds``
  (JAX's cold requests waited out an XLA compile; the port's are those
  that waited out an ``nvcc`` build, which the CPU never runs).
- Greedy ids with every sink on equal the JAX engine's and an all-off
  port engine's.
- The HBM pre-flight sheds the same requests as JAX under the same
  ``PADDLE_HBM_BUDGET_BYTES``; ``fixed_bytes`` and committed pages equal.
- Tracing: one request's span names and parent links equal JAX's; ids
  are OTLP-shaped; the exports load; ``merge_rank_traces`` merges.
- Memory, numerics, watchdog: owner rows, OOM recognition and dumps,
  ``stats_row`` within 1e-6 relative of JAX's, the same anomaly episodes,
  one flight record per wedge.

Every JAX engine here runs on a replica name of its own: the JAX metrics
registry is process-wide."""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import flight_recorder as jflight
from paddle_tpu.observability import memory as jmemory
from paddle_tpu.observability import numerics as jnumerics
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.profiler import events as jevents
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.resilience import retry as jretry
from paddle_tpu.serving import RequestRejectedError as JRejected
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import (faults, flight_recorder, memory,
                                            numerics, slo, tracing, watchdog)
from paddle_tpu_torch.profiler import events, metrics
from paddle_tpu_torch.resilience import retry
from paddle_tpu_torch.serving import RequestRejectedError, ServingEngine
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8
MAXLEN = 64


def tiny_jax_gpt(train_steps=5, seed=0):
    """Tiny GPT, briefly trained so greedy decode emits varied tokens
    (the recipe of tests/test_serving.py)."""
    paddle.seed(seed)
    m = JGPT(**CFG)
    o = opt.AdamW(learning_rate=1e-2, parameters=m.parameters())
    step = paddle.jit.TrainStep(m, o, loss_fn=None)
    ids = paddle.to_tensor(
        np.random.RandomState(0).randint(1, 96, (8, 20)).astype("int64"))
    for _ in range(train_steps):
        step({"input_ids": ids, "labels": ids})
    return m.eval()


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


@pytest.fixture(scope="module")
def jax_model():
    return tiny_jax_gpt()


@pytest.fixture(scope="module")
def model(jax_model):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(
        m, {k: np.asarray(v._value) for k, v in jax_model.state_dict().items()})
    return m.eval()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()
    numerics.set_nan_inject_row(0)
    jnumerics.set_nan_inject_row(0)
    for mod in (tracing, jtracing):
        if mod.get_tracer() is not None:
            mod.get_tracer().stop()
    flight_recorder.disable()
    jflight.disable()


def _wait(cond, budget=60.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < budget, "condition never held"
        time.sleep(0.005)


# ================================================================ registry
def _ops_basic(m, reg):
    c = reg.counter("t.requests", "requests by status")
    c.inc(status="ok")
    c.inc(2, status="ok")
    c.inc(status="err")
    c.inc(0.5)
    g = reg.gauge("t.depth", "queue depth")
    g.set(3)
    g.inc(2.5)
    g.labels(pool="a").dec(1)
    reg.gauge("t.empty", "registered, never set")


def _ops_histograms(m, reg):
    h = reg.histogram("t.lat_seconds", "latency")
    for v in (0.0001, 0.003, 0.07, 2.0, 40.0):
        h.observe(v)
    h2 = reg.histogram("t.custom", "custom edges", buckets=(0.5, 0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 5):
        h2.observe(v, path="/x")
    # a second caller's edges MERGE into the existing metric
    reg.histogram("t.custom", buckets=(0.25,))
    h2.observe(0.2, path="/y")


def _ops_bound(m, reg):
    b = m.bind(reg.counter("t.bound", "bound counter"), replica="7")
    b.inc()
    b.inc(3, reason="x")
    bg = m.bind(reg.gauge("t.bound_g", "bound gauge"), replica="7")
    bg.set(1.25)
    bg.dec(0.25, tier="t")
    bh = m.bind(reg.histogram("t.bound_h", "bound histogram"), replica="7")
    bh.observe(0.02)
    bh.observe(0.2, tier="t")
    assert b.get(reason="x") == 3.0 and bh.get() == 0.02


def _ops_slo_aligned(m, reg):
    jm_slo = jslo if m is jmetrics else slo
    edges = jm_slo.slo_histogram_buckets(m._DEFAULT_BUCKETS, 0.3, None, 0.05)
    h = reg.histogram("t.ttft_seconds", "slo-aligned", buckets=edges)
    for v in (0.01, 0.15, 0.3, 0.31, 0.6, 0.61):
        h.observe(v, replica="0")
    reg.counter("t.weird-name.x", 'help with "quotes"').inc(
        label='a"b\\c\nd')


_REGISTRY_OPS = [_ops_basic, _ops_histograms, _ops_bound, _ops_slo_aligned]


@pytest.mark.parametrize("ops", _REGISTRY_OPS,
                         ids=[f.__name__[5:] for f in _REGISTRY_OPS])
def test_registry_exports_equal_jax(ops):
    """Prometheus text byte-equal, JSONL rows equal apart from the
    timestamp, on fresh registries of each package."""
    regs = []
    for m in (jmetrics, metrics):
        reg = m.MetricsRegistry()
        ops(m, reg)
        regs.append(reg)
    jreg, treg = regs
    assert treg.to_prometheus() == jreg.to_prometheus()
    rows = [[{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in r.to_jsonl().splitlines()] for r in regs]
    assert rows[1] == rows[0] and rows[1]
    assert treg.collect() == jreg.collect()


def test_jsonl_snapshot_round_trip(tmp_path):
    reg = metrics.MetricsRegistry()
    _ops_basic(metrics, reg)
    _ops_histograms(metrics, reg)
    path = reg.export_snapshot(str(tmp_path / "snap"))
    reg.export_snapshot(str(tmp_path / "snap"))          # appended
    rows = metrics.load_jsonl(path)
    want = reg.collect()
    assert len(rows) == 2 * len(want)
    assert [{k: v for k, v in r.items() if k != "time"}
            for r in rows[:len(want)]] == want
    # the reference's reader reads the port's file the same way
    assert jmetrics.load_jsonl(path) == rows
    prom = (tmp_path / "snap" / "metrics.prom").read_text()
    assert prom == reg.to_prometheus()


def test_set_buckets_and_type_conflicts_match_jax():
    out = []
    for m in (jmetrics, metrics):
        reg = m.MetricsRegistry()
        h = reg.histogram("x", buckets=(1.0,))
        h.observe(0.5, a="1")
        with pytest.warns(UserWarning):
            h.set_buckets((0.1, 2.0))
        h.observe(0.5, a="2")
        with pytest.raises(TypeError):
            reg.counter("x")
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        out.append(reg.to_prometheus())
    assert out[1] == out[0]


def test_record_event_tree_and_torch_profiler():
    """RecordEvent feeds the host event tree, as JAX's does, and shows up
    as a labelled range in a torch.profiler trace."""
    summaries = []
    for ev in (jevents, events):
        col = ev.EventCollector().start()
        try:
            with ev.RecordEvent("outer"):
                for _ in range(3):
                    with ev.record("inner"):
                        pass
            with ev.RecordEvent("outer"):
                pass
        finally:
            col.stop()
        summaries.append({k: v["calls"] for k, v in col.op_summary().items()})
        assert [r.name for r in col.roots] == ["outer", "outer"]
    assert summaries[1] == summaries[0] == {"outer": 2, "inner": 3}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with events.RecordEvent("port.region"):
            torch.ones(4).sum()
    assert any(e.key == "port.region" for e in prof.key_averages())


# ================================================================= tracing
def test_span_ids_nesting_and_exports(tmp_path):
    tr = tracing.Tracer(rank=3).start()
    with tracing.span("outer", step=1) as outer:
        with tracing.span("inner") as inner:
            assert tracing.current_trace_id() == outer.trace_id
            assert {"outer", "inner"} <= {
                sp["name"] for sp in tracing.open_spans()}
        ev = tracing.event("point", links=["ab" * 16])
    with tracing.span("rooted", trace_id="cd" * 16) as rooted:
        pass
    tr.stop()
    assert tracing.span("off") is tracing.NOOP
    assert re.fullmatch(r"[0-9a-f]{32}", outer.trace_id)
    assert re.fullmatch(r"[0-9a-f]{16}", outer.span_id)
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert ev.parent_id == outer.span_id
    assert rooted.trace_id == "cd" * 16 and rooted.parent_id is None
    chrome = json.load(open(tr.export_chrome(str(tmp_path / "c.json"))))
    assert [e["name"] for e in chrome["traceEvents"]] \
        == ["inner", "point", "outer", "rooted"]
    assert chrome["metadata"]["rank"] == 3
    assert chrome["traceEvents"][0]["args"]["parent_id"] == outer.span_id
    otlp = json.load(open(tr.export_otlp(str(tmp_path / "o.json"))))
    spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert {s["name"] for s in spans} == {"inner", "point", "outer", "rooted"}
    point = next(s for s in spans if s["name"] == "point")
    assert point["links"] == [{"traceId": "ab" * 16, "spanId": ""}]
    assert all(int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"])
               for s in spans)


def test_merge_rank_traces_matches_jax(tmp_path):
    """Two ranks' files merge onto the earliest clock, as JAX merges the
    same files."""
    for rank, t0 in ((0, 1000.0), (1, 1000.5)):
        tr = tracing.Tracer(rank=rank)
        tr.clock_unix = t0
        tr.start()
        with tracing.span(f"step{rank}"):
            pass
        tr.stop()
        tr.export_chrome(str(tmp_path / f"rank{rank}.json"))
    got = tracing.merge_rank_traces(str(tmp_path),
                                    out_path=str(tmp_path / "m" / "all.json"))
    want = jtracing.merge_rank_traces(str(tmp_path))
    assert got == want
    assert got["metadata"]["merged_ranks"] == [0, 1]
    ev = {e["name"]: e for e in got["traceEvents"] if e["ph"] == "X"}
    assert ev["step1"]["ts"] - ev["step0"]["ts"] > 4e5     # 0.5 s later
    assert json.load(open(tmp_path / "m" / "all.json")) == got
    with pytest.raises(FileNotFoundError):
        tracing.merge_rank_traces(str(tmp_path / "nope"))


def _request_spans(mod, eng, prompt, n):
    tr = mod.Tracer().start()
    with eng:
        h = eng.submit(prompt, max_new_tokens=n)
        h.result(timeout=300)
    tr.stop()
    mine = sorted((s.name, s.parent_id is None, s.attrs.get("request_id"))
                  for s in tr.spans if s.trace_id == h.trace_id)
    steps = [s for s in tr.spans
             if h.trace_id in s.attrs.get("links", ())]
    return mine, sorted({s.name for s in steps}), len(steps), h.trace_id


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk_tokens": 8},
                                {"speculative_k": 3}],
                         ids=["plain", "chunked", "spec"])
def test_request_spans_equal_jax(jax_model, model, kw):
    prompt = [2, 3, 4] * 6 if kw.get("speculative_k") else _prompt(20, 3)
    jeng = JServingEngine(jax_model, num_slots=2, page_size=PS,
                          max_model_len=MAXLEN, replica=f"j-span-{len(kw)}"
                          + "".join(kw), **kw)
    teng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                         max_model_len=MAXLEN, **kw)
    want = _request_spans(jtracing, jeng, prompt, 8)
    got = _request_spans(tracing, teng, prompt, 8)
    assert got[:3] == want[:3]
    assert re.fullmatch(r"[0-9a-f]{32}", got[3])
    assert ("serving.submit", True, 0) in got[0]


# ============================================================ engine runs
def _side_engine(name, mdl, replica, **kw):
    kw.setdefault("num_slots", 2)
    if name == "jax":
        return JServingEngine(mdl, page_size=PS, max_model_len=MAXLEN,
                              replica=replica, **kw)
    return ServingEngine(mdl, device="cpu", page_size=PS,
                         max_model_len=MAXLEN, replica=replica, **kw)


_HELD_GAUGES = {}     # replica -> the queue gauges read inside the hold


def _held(name, eng, fn):
    """Run ``fn()`` while the scheduler sits in a wedge (one admission
    pass then sees everything submitted), refreshing the gauges there and
    keeping the queue-depth gauges as they read at that moment (later
    refreshes are throttled by time, so the end values are not a run's
    to decide)."""
    f = jfaults if name == "jax" else faults
    site = f"serving.scheduler_wedge@{eng.replica}"
    f.inject(site, seconds=30.0, times=1)
    _wait(lambda: f.trip_count(site) >= 1)
    out = fn()
    eng._gauges_t = 0.0
    eng._update_gauges()
    _HELD_GAUGES[eng.replica] = {
        k: v for k, v in _series(name, eng.replica).items()
        if k[0] in ("serving.queue_depth", "serving.tier.queue_depth",
                    "serving.pages_in_use")}
    f.clear(site)
    return out


def _series(name, replica):
    """``{(family, labels-without-replica): value}`` of every serving.*
    series of ``replica``: counters and gauges by value, histograms by
    their observation count."""
    reg = (jmetrics if name == "jax" else metrics).get_registry()
    out = {}
    for m in reg.metrics():
        if not m.name.startswith("serving."):
            continue
        for c in list(m._children.values()):
            if c.labels.get("replica") != replica:
                continue
            key = (m.name, tuple(sorted((k, v) for k, v in c.labels.items()
                                        if k != "replica")))
            out[key] = c.count if m.kind == "histogram" else c.value
    return out


def _faults_run(name, eng, reqs):
    f = jfaults if name == "jax" else faults
    rej = JRejected if name == "jax" else RequestRejectedError
    err = jretry if name == "jax" else retry

    def boom():
        raise err.TransientError("injected decode crash")

    def submit():
        hs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        with pytest.raises(rej) as ei:
            eng.submit(_prompt(5, 99), max_new_tokens=3)
        assert ei.value.reason == "queue_full"
        f.inject("serving.step_crash", fn=boom, at_trips={4})
        return hs
    return _held(name, eng, submit)


def _nan_run(name, eng, reqs):
    f = jfaults if name == "jax" else faults
    (jnumerics if name == "jax" else numerics).set_nan_inject_row(1)
    return _held(name, eng, lambda: (
        [eng.submit(p, max_new_tokens=n) for p, n in reqs],
        f.inject("numerics.nan_inject", at_trips={5}))[0])


def _qos_run(name, eng, reqs):
    """Two batch requests fill the slots; a realtime one preempts."""
    hs = _held(name, eng, lambda: [
        eng.submit(p, max_new_tokens=n, tier="batch") for p, n in reqs])
    _wait(lambda: all(len(h.token_ids) >= 2 for h in hs))
    hs.append(eng.submit(_prompt(6, 77), max_new_tokens=5,
                         tier="realtime"))
    return hs


def _plain_run(name, eng, reqs):
    return _held(name, eng, lambda: [eng.submit(p, max_new_tokens=n)
                                     for p, n in reqs])


def _radix_run(name, eng, reqs):
    """Sequential requests over a 6-page pool: shared prefixes hit, idle
    ones spill and come back."""
    hs = []
    for p, n in reqs:
        hs.append(eng.submit(p, max_new_tokens=n))
        hs[-1].result(timeout=300)
    return hs


_SHARED = _prompt(24, 42)
_CASES = {
    "faults": (dict(max_queue=2), _faults_run,
               [(_prompt(6, 70), 12), (_prompt(9, 71), 10)]),
    "guard": (dict(numeric_guard=True), _nan_run,
              [(_prompt(5, 11), 10), (_prompt(13, 12), 10)]),
    "spec": (dict(speculative_k=4), _plain_run,
             [([2, 3, 4] * 4, 12), (_prompt(9, 71), 10)]),
    "chunked": (dict(prefill_chunk_tokens=8), _plain_run,
                [(_prompt(30, 5), 6), (_prompt(20, 6), 6),
                 ([7, 8, 9], 6)]),
    "radix": (dict(num_slots=1, num_pages=6, prefix_cache="radix",
                   kv_spill=True), _radix_run,
              [(_SHARED + _prompt(6, 1), 6), (_prompt(30, 2), 6),
               (_SHARED + _prompt(5, 3), 6), (_prompt(28, 4), 6),
               (_SHARED + _prompt(4, 5), 6)]),
    "qos": (dict(qos=True), _qos_run,
            [(_prompt(6, 30), 30), (_prompt(7, 31), 30)]),
    "int8": (dict(kv_dtype="int8", weight_dtype="int8"), _plain_run,
             [(_prompt(6, 40), 12), (_prompt(9, 41), 12)]),
    # a 6-page pool: the second request waits for the first's pages
    "blocked": (dict(num_pages=6), _plain_run,
                [(_prompt(20, 50), 12), (_prompt(22, 51), 10)]),
}


@pytest.fixture(scope="module")
def int8_models(jax_model, model):
    """Models converted to int8 weights (in place, so copies)."""
    jm = tiny_jax_gpt()
    tm = GPTForCausalLM(device="cpu", **CFG)
    tm.load_state_dict(model.state_dict())
    return jm, tm.eval()


def _run_case(case, name, mdl):
    """One case through one package.  The faults case also runs under an
    HBM budget far above its need, so the pre-flight's reservations ride
    through the restart: the committed pages read 0 once all is done."""
    kw, run, reqs = _CASES[case]
    replica = f"{name[0]}-obs-{case}"
    eng = _side_engine(name, mdl, replica, **kw)
    if case == "faults":
        os.environ["PADDLE_HBM_BUDGET_BYTES"] = str(1 << 40)
    try:
        with eng:
            eng.generate(_prompt(4, 3), max_new_tokens=2, timeout=300)
            hs = run(name, eng, reqs)
            outs, status = [], []
            for h in hs:
                try:
                    outs.append(h.result(timeout=300))
                except Exception as e:      # the NaN lane's NumericFault
                    outs.append(type(e).__name__)
                status.append(h.status)
            (faults if name == "torch" else jfaults).clear()
            stats = eng.stats() if name == "torch" else None
    finally:
        os.environ.pop("PADDLE_HBM_BUDGET_BYTES", None)
    return outs, status, _series(name, replica), stats, \
        _HELD_GAUGES.get(replica), eng._committed_pages


@pytest.fixture(scope="module")
def case_runs(jax_model, model, int8_models):
    """Every case through both packages once; the tests below read it."""
    out = {}
    for case in _CASES:
        jm, tm = int8_models if case == "int8" else (jax_model, model)
        out[case] = (_run_case(case, "jax", jm),
                     _run_case(case, "torch", tm))
    return out


def _comparable(series):
    return {k: v for k, v in series.items()
            if not k[0].endswith("_traces")
            and k[0] != "serving.ttft_cold_seconds"}


@pytest.mark.parametrize("case", list(_CASES))
def test_engine_families_and_counts_equal_jax(case_runs, case):
    (jout, jst, jser, _, jheld, jpages), \
        (tout, tst, tser, stats, theld, tpages) = case_runs[case]
    assert tout == jout and tst == jst
    assert tpages == jpages == 0
    a, b = _comparable(tser), _comparable(jser)
    # the same families carry a series for the replica, with the same
    # label sets, counter values and histogram counts; of the gauges,
    # those a run determines (pool bytes, acceptance, spill bytes, and the
    # queue gauges as they read inside the admission hold)
    assert {k[0] for k in a} == {k[0] for k in b}
    assert a.keys() == b.keys()
    assert theld == jheld
    kinds = {m.name: m.kind for m in metrics.get_registry().metrics()}
    det = ("serving.pool_bytes", "serving.kv_bytes_per_token",
           "serving.acceptance_rate", "serving.kv_spill_bytes")
    for k in a:
        if kinds[k[0]] != "gauge" or k[0] in det:
            assert a[k] == b[k], k
    # the program mint counters count as the reference's do (one per key
    # per model store)
    traces = {k for k in tser if k[0].endswith("_traces")}
    assert traces == {k for k in jser if k[0].endswith("_traces")}
    assert all(tser[k] == jser[k] for k in traces), \
        {k[0]: (tser[k], jser[k]) for k in traces}
    # stats() reports the registry's counts
    reg = metrics.get_registry()
    rep = f"t-obs-{case}"
    assert stats["engine_restarts"] == (
        reg.get("serving.engine_restarts").get(replica=rep) or 0)
    assert stats["requests_requeued"] == (
        reg.get("serving.requests_requeued").get(replica=rep) or 0)
    assert stats["numeric_faults"] == (
        reg.get("serving.numeric_faults").get(replica=rep) or 0)
    assert stats["spec_proposed"] == (
        reg.get("serving.spec_proposed").get(replica=rep) or 0)
    for reason, n in stats["load_shed"].items():
        assert n == sum(c.value for c in reg.get("serving.load_shed")
                        ._children.values()
                        if c.labels.get("replica") == rep
                        and c.labels.get("reason") == reason)


def test_cases_exercise_what_they_name(case_runs):
    """Each case moved the counters it is there for (so the equality above
    is not an equality of zeros)."""
    def val(case, fam, **labels):
        return case_runs[case][1][2].get((fam, tuple(sorted(labels.items()))))

    assert val("faults", "serving.engine_restarts") == 1
    assert val("faults", "serving.requests_requeued") == 2
    assert val("faults", "serving.load_shed", reason="queue_full") == 1
    assert val("guard", "serving.numeric_faults") == 1
    assert val("spec", "serving.spec_proposed") > 0
    assert val("spec", "serving.spec_accepted") > 0
    assert val("chunked", "serving.prefill_chunk_seconds") >= 6
    assert val("radix", "serving.prefix_cache_hits") > 0
    assert val("radix", "serving.prefix_cache_saved_tokens") > 0
    assert val("radix", "serving.kv_spill_pages") > 0
    assert val("radix", "serving.kv_spill_resurrections") > 0
    assert val("qos", "serving.preemptions", reason="qos",
               tier="batch") == 1
    assert case_runs["qos"][1][4][
        ("serving.tier.queue_depth", (("tier", "batch"),))] == 2
    assert val("qos", "serving.ttft_seconds", tier="realtime") == 1
    assert val("int8", "serving.pool_bytes", dtype="int8") > 0
    assert val("int8", "serving.pool_bytes", dtype="float32") > 0
    assert val("faults", "serving.tokens_generated") == 2 + 12 + 10
    assert val("blocked", "serving.admissions_blocked") >= 5


def test_engine_families_cover_the_reference():
    """Every serving.* family the reference engine, BlockManager, spill
    tier and SLO accountant register is in the port's registry."""
    src = "".join(open(os.path.join(REPO, "paddle_tpu", "serving", f)).read()
                  for f in ("engine.py", "block_manager.py", "kv_spill.py"))
    src += open(os.path.join(REPO, "paddle_tpu", "observability",
                             "slo.py")).read()
    want = set(re.findall(
        r'(?:_h|_g|_c|counter|gauge|histogram)\(\s*"(serving\.[a-z_.]+)"',
        src))
    assert len(want) > 40
    ServingEngine(GPTForCausalLM(device="cpu", **CFG), device="cpu",
                  page_size=PS, max_model_len=MAXLEN, prefix_cache="radix",
                  kv_spill=True, replica="t-obs-families",
                  slo=slo.SLOPolicy(ttft_s=1.0))
    have = {m.name for m in metrics.get_registry().metrics()}
    assert want <= have, sorted(want - have)


def test_everything_on_gives_the_all_off_ids(jax_model, model, tmp_path):
    """Tracer, flight recorder, telemetry, SLO and the numeric guard on:
    greedy ids equal an all-off port engine's and the JAX engine's."""
    prompts = [_prompt(5, 21), _prompt(17, 22), _prompt(30, 23)]
    jeng = _side_engine("jax", jax_model, "j-obs-allon")
    with jeng:
        want = [jeng.generate(p, max_new_tokens=8, timeout=300)
                for p in prompts]
    off = _side_engine("torch", model, "t-obs-off")
    with off:
        got_off = [off.generate(p, max_new_tokens=8, timeout=300)
                   for p in prompts]
    tr = tracing.Tracer().start()
    flight_recorder.enable(dir=str(tmp_path))
    on = _side_engine("torch", model, "t-obs-on", telemetry_port=0,
                      numeric_guard=True,
                      slo=slo.SLOPolicy(ttft_s=5.0, itl_s=5.0))
    with on:
        got_on = [on.generate(p, max_new_tokens=8, timeout=300)
                  for p in prompts]
        assert on.telemetry is not None
    tr.stop()
    assert got_on == got_off == want
    assert tr.find("serving.prefill") and tr.find("serving.decode_step")
    reg = metrics.get_registry()
    assert reg.get("serving.slo.requests").get(replica="t-obs-on",
                                               met="true") == 3
    assert reg.get("serving.slo.attainment").get(replica="t-obs-on") == 1.0
    assert on.telemetry is None            # stopped with the engine


# ============================================================ HBM pre-flight
def test_hbm_preflight_sheds_like_jax(jax_model, model, monkeypatch):
    reqs = [(_prompt(10, 81), 20), (_prompt(30, 82), 20),
            (_prompt(6, 83), 4), (_prompt(20, 84), 30)]

    def run(name, mdl):
        eng = _side_engine(name, mdl, f"{name[0]}-obs-hbm")
        rej = JRejected if name == "jax" else RequestRejectedError
        with eng:
            eng.generate(_prompt(4, 3), max_new_tokens=2, timeout=300)
            budget = eng._fixed_bytes + 8 * eng._bytes_per_page
            monkeypatch.setenv("PADDLE_HBM_BUDGET_BYTES", str(budget))

            def submit():
                out = []
                for p, n in reqs:
                    try:
                        out.append(eng.submit(p, max_new_tokens=n))
                    except rej as e:
                        out.append(e.reason)
                return out, eng._committed_pages
            hs, committed = _held(name, eng, submit)
            ids = [h if isinstance(h, str) else h.result(timeout=300)
                   for h in hs]
            monkeypatch.delenv("PADDLE_HBM_BUDGET_BYTES")
            return ids, committed, eng._committed_pages, eng._fixed_bytes

    want, got = run("jax", jax_model), run("torch", model)
    assert got == want
    ids, committed, after, fixed = got
    # 4 + 7 pages > 8 sheds the second, 4 + 2 fit, 6 + 7 sheds the last
    assert ids.count("hbm_budget") == 2 and committed == 6 and after == 0
    assert fixed == sum(p.numel() * p.element_size()
                        for p in model.parameters())
    # the admitted requests' ids are those of an unbudgeted engine
    plain = _side_engine("torch", model, "t-obs-hbm-plain")
    with plain:
        for (p, n), out in zip(reqs, ids):
            if not isinstance(out, str):
                assert plain.generate(p, max_new_tokens=n,
                                      timeout=300) == out


def test_hbm_budget_env_parsing_matches_jax(monkeypatch):
    for v in (None, "", "1e6", "12345", "junk"):
        if v is None:
            monkeypatch.delenv("PADDLE_HBM_BUDGET_BYTES", raising=False)
        else:
            monkeypatch.setenv("PADDLE_HBM_BUDGET_BYTES", v)
        assert memory.hbm_budget_bytes() == jmemory.hbm_budget_bytes()


# ================================================================= memory
@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"}],
                         ids=["native", "int8"])
def test_ledger_owner_rows_equal_jax(jax_model, model, kw):
    rows = []
    for name, mdl in (("jax", jax_model), ("torch", model)):
        rep = f"{name[0]}-obs-mem-{len(kw)}"
        eng = _side_engine(name, mdl, rep, **kw)
        led = (jmemory if name == "jax" else memory).ledger()
        rows.append(sorted((r["owner"], r["bytes"], r["arrays"])
                           for r in led.owner_rows(replica=rep)))
        del eng
    # the port's graph pool (its programs' CUDA graphs) is a row of its
    # own: 0 bytes on the CPU, where a program is the eager step
    assert ("programs.graph_pool", 0, 0) in rows[1]
    rows[1].remove(("programs.graph_pool", 0, 0))
    assert rows[1] == rows[0]
    assert {r[0] for r in rows[1]} >= {"kv.pages", "model.params"}


def test_ledger_report_on_the_cpu_has_no_untracked_number():
    led = memory.MemoryLedger(registry=metrics.MetricsRegistry())
    a, b = torch.zeros(10), torch.zeros(5, dtype=torch.int8)
    reg = led.register("kv.pages", lambda: [a, b], replica="r")
    led.register("model.params", lambda: [a], replica="r")   # shared tensor
    led.register("kv.spilled", nbytes=100, replica="r", device="host")
    rep = led.report()
    assert rep["tracked_bytes"] == 45
    assert rep["untracked_bytes"] is None and rep["live_bytes"] is None
    assert rep["owners"][-1] == {"owner": "untracked", "replica": "-",
                                 "device": "-", "bytes": None,
                                 "arrays": None}
    assert led.owner_totals() == {"kv.pages": 45, "model.params": 40,
                                  "kv.spilled": 100}
    reg.unregister()
    assert "kv.pages" not in led.owner_totals()


@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: failed to allocate"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("bad shape"), False),
])
def test_is_oom_error(exc, want):
    assert memory.is_oom_error(exc) is want


def test_oom_dump_and_memory_watchdog(tmp_path):
    flight_recorder.enable(dir=str(tmp_path))
    path = memory.oom_dump(torch.cuda.OutOfMemoryError("CUDA out of memory"),
                           replica="r")
    doc = json.load(open(path))
    jdoc = json.load(open(jflight.FlightRecorder(dir=str(tmp_path)).dump(
        "oom", extra={"k": 1})))
    assert doc.keys() == jdoc.keys() and doc["reason"] == "oom"
    assert doc["extra"]["replica"] == "r"
    assert "owners" in doc["extra"]["memory"]
    # the memory.leak fault grows a synthetic owner: one dump per episode
    memory.reset()
    try:
        wd = memory.MemoryWatchdog(windows=2)
        faults.inject("memory.leak", every=1)
        fired = [wd.tick() for _ in range(5)]
        assert [len(f) for f in fired] == [0, 0, 1, 0, 0]
        doc = json.load(open(fired[2][0]))
        assert doc["reason"] == "memory_leak"
        assert doc["extra"]["leaking_owner"] == "fault.memory_leak"
    finally:
        faults.clear()
        memory.reset()


# ================================================================ numerics
def _stats_inputs():
    rs = np.random.RandomState(0)
    base = rs.randn(7, 33).astype(np.float32)
    poisoned = base.copy()
    poisoned[0, 0], poisoned[1, 3], poisoned[2, 5] = np.nan, np.inf, -np.inf
    zeros = np.zeros((4, 5), np.float32)
    zeros[0, 0] = 3.0
    sub = np.array([1e-39, -1e-40, 5e-41, 0.0, 1.0, 2.0e38, 1e-5],
                   np.float32)
    big = (rs.randn(64) * 1e5).astype(np.float32)
    return {"random": base, "poisoned": poisoned, "zeros": zeros,
            "subnormal": sub, "big": big, "empty": np.zeros((0,), np.float32)}


@pytest.mark.parametrize("name", list(_stats_inputs()))
@pytest.mark.parametrize("low", ["bfloat16", "float16"])
def test_stats_row_equals_jax(name, low):
    """Within 1e-6 relative (the sums run in another order)."""
    x = _stats_inputs()[name]
    want = np.asarray(jnumerics.stats_row(jnp.asarray(x), low))
    got = numerics.stats_row(torch.from_numpy(x), low).numpy()
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name == "subnormal":
        # bf16 subnormals: the input held as bf16 on both sides
        jb = np.asarray(jnumerics.stats_row(jnp.asarray(x, jnp.bfloat16),
                                            low))
        tb = numerics.stats_row(torch.from_numpy(x).bfloat16(), low).numpy()
        np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=0)
        # float32 subnormals count as zeros on both sides
        assert tb[3] == pytest.approx(4 / 7)
    assert numerics.tensor_stats(torch.from_numpy(x), low) == pytest.approx(
        jnumerics.tensor_stats(jnp.asarray(x), low), rel=1e-6, abs=0)


def _episodes(num, stream, tables, raise_at=None):
    out = []
    for step, (sites, table) in enumerate(tables):
        dev = jnp.asarray(table) if num is jnumerics \
            else torch.from_numpy(table)
        num.submit(stream, sites, dev, step=step)
        eps = num.poll(stream, raise_on_fault=(step == raise_at))
        out.append([(e.kind, e.stream, e.step, e.site, e.value)
                    for e in eps])
    return out


def test_poll_episodes_equal_jax():
    """Non-finite episodes (one per episode, re-armed when clean) and a
    loss spike, through submit / poll: the same episodes in both."""
    rs = np.random.RandomState(5)
    tables = []
    for i in range(14):
        t = np.abs(rs.randn(3, 6)).astype(np.float32) * 0.1
        t[:, 0] = 0.0
        t[2, 2] = 1.0 + 0.01 * i                 # loss rms, steady
        if i in (3, 4, 9):
            t[1, 0] = 2.0                        # non-finite in "layer"
        if i == 12:
            t[2, 2] = 50.0                       # loss spike
        tables.append((("grad.w", "layer", "loss"), t))
    with pytest.warns(RuntimeWarning):
        want = _episodes(jnumerics, "jobs/poll", tables)
    with pytest.warns(RuntimeWarning):
        got = _episodes(numerics, "jobs/poll", tables)
    assert [[e[:1] + e[2:] for e in s] for s in got] \
        == [[e[:1] + e[2:] for e in s] for s in want]
    kinds = [e[0] for s in got for e in s]
    assert kinds == ["nonfinite", "nonfinite", "loss_spike"]
    latest = numerics.latest("jobs/poll")
    assert latest["step"] == 13 and latest["sites"][2] == "loss"
    reg = metrics.get_registry()
    assert reg.get("numerics.rms").get(site="jobs/poll", tensor="loss") \
        == pytest.approx(float(tables[-1][1][2, 2]))


def test_poll_raise_on_fault_raises_numeric_fault():
    bad = np.zeros((1, 6), np.float32)
    bad[0, 0] = 3.0
    for num, fault in ((jnumerics, jretry.NumericFault),
                       (numerics, retry.NumericFault)):
        with pytest.warns(RuntimeWarning):
            with pytest.raises(fault) as ei:
                _episodes(num, "jobs/raise", [(("logits",), bad)],
                          raise_at=0)
        assert ei.value.site == "logits"
        num.submit("jobs/raise", ("logits",),
                   jnp.zeros((1, 6)) if num is jnumerics
                   else torch.zeros(1, 6))
        num.poll("jobs/raise")                     # clean: episode over
    assert numerics.maybe_poll() == []             # nothing pending


def test_check_numerics_levels_match_jax():
    x = np.array([1.0, np.nan, 2.0], np.float32)
    try:
        for num, arr in ((jnumerics, jnp.asarray(x)),
                         (numerics, torch.from_numpy(x))):
            num.enable_tensor_checker(level="warn")
            with pytest.warns(RuntimeWarning):
                st = num.check_numerics(arr, name="probe.a", stream="t-chk")
            assert st["nonfinite"] == 1.0
            num.enable_tensor_checker(level="abort")
            with pytest.raises(FloatingPointError):
                num.check_numerics(arr, name="probe.b", stream="t-chk")
            num.enable_tensor_checker(level="warn", exclude=("skip",))
            num.check_numerics(arr, name="skip.me", stream="t-chk")
        sz = numerics.statusz()
        assert {"enabled", "level", "streams", "pending", "episodes",
                "amp"} <= sz.keys()
        with pytest.raises(ValueError):
            numerics.TensorCheckerConfig(level="loud")
    finally:
        jnumerics.disable_tensor_checker()
        numerics.disable_tensor_checker()


def test_guarded_engine_feeds_the_numerics_stream(model):
    """A guarded engine parks its logits' stats row; the NaN lane shows as
    a non-finite episode once the stream is resolved."""
    eng = _side_engine("torch", model, "t-obs-nstream", numeric_guard=True)
    with eng:
        eng.generate(_prompt(6, 1), max_new_tokens=3, timeout=300)
        numerics.poll("serving/t-obs-nstream")
        clean = numerics.latest("serving/t-obs-nstream")
        assert clean["sites"] == ("logits",)
        assert clean["table"][0, 0] == 0 and clean["table"][0, 1] > 0
        faults.inject("numerics.nan_inject", times=1)
        h = eng.submit(_prompt(6, 2), max_new_tokens=3)
        with pytest.raises(retry.NumericFault):
            h.result(timeout=300)
        with pytest.warns(RuntimeWarning):
            eps = numerics.poll("serving/t-obs-nstream")
    assert [e.kind for e in eps] == ["nonfinite"]
    assert eps[0].site == "logits"


# ========================================================= watchdog, flight
def test_watchdog_fire_dumps_one_flight_record(model, tmp_path):
    """A wedge fires the watchdog once: one flight record with the
    reference's top-level keys, counted by observability.flight_dumps,
    and every fire listener is called."""
    flight_recorder.enable(dir=str(tmp_path))
    seen = []
    listener = lambda kind, rec: seen.append((kind, rec["dump_path"]))  # noqa: E731
    watchdog.add_fire_listener(listener)
    dumps = metrics.counter("observability.flight_dumps")
    before = dumps.get(reason="serving_watchdog") or 0
    try:
        eng = _side_engine("torch", model, "t-obs-wd", num_slots=1,
                           watchdog_s=0.2)
        with eng:
            eng.generate(_prompt(4, 90), max_new_tokens=2, timeout=300)
            faults.inject("serving.scheduler_wedge", seconds=30.0, times=1)
            _wait(lambda: faults.trip_count("serving.scheduler_wedge") >= 1)
            h = eng.submit(_prompt(5, 91), max_new_tokens=3)
            _wait(lambda: len(eng.watchdog.fired) >= 1)
            time.sleep(0.3)                 # still wedged: no second fire
            faults.clear()
            assert len(h.result(timeout=300)) == 3
    finally:
        watchdog.remove_fire_listener(listener)
    assert len(eng.watchdog.fired) == 1
    files = sorted(tmp_path.glob("flight_*_serving_watchdog_*.json"))
    assert len(files) == 1 and seen == [("serving", str(files[0]))]
    doc = json.load(open(files[0]))
    jdoc = json.load(open(jflight.FlightRecorder(dir=str(tmp_path)).dump(
        "serving_watchdog", extra={"k": 1})))
    assert doc.keys() == jdoc.keys()
    assert doc["schema"] == jdoc["schema"]
    assert doc["extra"]["stats"]["queue_depth"] >= 1
    assert any(e["kind"] == "watchdog" for e in doc["events"])
    assert dumps.get(reason="serving_watchdog") == before + 1
    assert metrics.counter("observability.watchdog_fires").get(
        kind="serving", op="scheduler_wedge") >= 1


_CRASH_SCRIPT = r"""
import os, signal, sys
sys.path.insert(0, os.environ["REPO"])
from paddle_tpu_torch import observability as obs
assert obs.flight_recorder.enabled()   # armed at import from the env
with obs.span("doomed_op", step=7):
    pass
print("READY", flush=True)
os.kill(os.getpid(), signal.SIGTERM)
raise SystemExit("unreachable")
"""


def test_flight_env_arms_and_dumps_on_sigterm(tmp_path):
    """``PADDLE_FLIGHT_DIR`` arms the ring at import and installs the
    crash handlers: a SIGTERM leaves a dump and still kills the
    process."""
    script = tmp_path / "crash.py"
    script.write_text(_CRASH_SCRIPT)
    env = dict(os.environ, PADDLE_FLIGHT_DIR=str(tmp_path / "flight"),
               REPO=REPO)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, timeout=240)
    assert "READY" in r.stdout, r.stderr
    assert r.returncode == -15, (r.returncode, r.stderr[-2000:])
    dumps = sorted((tmp_path / "flight").glob("flight_*_signal_SIGTERM_*"))
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "signal_SIGTERM"
    assert any(e["name"] == "doomed_op" for e in doc["events"])


def test_flight_ring_and_unhandled_exception(tmp_path):
    rec = flight_recorder.enable(dir=str(tmp_path), capacity=8)
    for i in range(20):
        rec.record("event", f"e{i}", i=i)
    with tracing.span("about_to_fail"):
        pass
    try:
        raise RuntimeError("boom for forensics")
    except RuntimeError:
        path = flight_recorder.handle_exception(*sys.exc_info())
    doc = json.load(open(path))
    assert doc["reason"] == "unhandled_exception"
    assert "boom for forensics" in doc["extra"]["exception"]
    assert len(doc["events"]) == 8
    assert any(e["name"] == "about_to_fail" for e in doc["events"])
    assert rec.last_dump_path == path
    flight_recorder.disable()
    assert not flight_recorder.enabled() and not tracing.enabled()


def test_slo_accountant_series_equal_jax():
    """The serving.slo.* series of one accountant fed the same timelines,
    and the cold-start cause of a miss only a build stall caused."""
    class H:
        def __init__(self, t0, times, compile_s=0.0):
            self.submitted_at, self.token_times = t0, times
            self.finished_at, self.compile_s = times[-1], compile_s

    handles = [H(0.0, [0.1, 0.2, 0.3]), H(1.0, [1.5, 1.6]),
               H(2.0, [2.05, 2.9]), H(3.0, [3.45, 3.5], compile_s=0.3)]
    texts = []
    for mod, m in ((jslo, jmetrics), (slo, metrics)):
        reg = m.MetricsRegistry()
        acct = mod.SLOAccountant(
            mod.SLOPolicy(ttft_s=0.2, itl_s=0.5, objective=0.9),
            registry=reg, replica="r")
        for h in handles:
            acct.observe(h)
        acct.observe(H(5.0, [5.01]), met_override=False)
        texts.append(reg.to_prometheus())
    assert texts[1] == texts[0]
    assert 'cause="cold_start"' in texts[1]
