"""PyTorch port, live telemetry: ``ServingEngine(telemetry_port=...)``
serving ``/metrics``, ``/healthz`` and ``/statusz`` on the CPU, beside the
JAX engine's endpoint on the same traffic.

- ``/metrics`` parses as Prometheus text and lists the same ``serving.*``
  families for the replica as the JAX engine's;
- ``/healthz`` answers the JAX server's codes through healthy, degraded
  and draining, with ``health_gating`` on and off;
- ``/statusz`` has the reference's top-level keys and the engine
  section's (``mp`` and ``pool_shard_bytes_by_dtype`` included), except
  the key the port leaves out by design: ``step_traces`` (a JAX
  program-trace count);
- the server starts from ``telemetry_port`` or ``PADDLE_TELEMETRY_PORT``,
  stops with the engine that started it, and a port already in use is
  logged while the engine serves on.

Every JAX engine here runs on a replica name of its own: the JAX metrics
registry is process-wide."""

import json
import logging
import re
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import telemetry as jtelemetry
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import faults, telemetry
from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8
MAXLEN = 64

# engine-section keys of the reference's /statusz the port leaves out
_LEFT_OUT = {"step_traces"}


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
def _clean():
    yield
    faults.clear()
    jfaults.clear()
    telemetry.shutdown()
    jtelemetry.shutdown()


def _engine(name, mdl, replica, **kw):
    kw.setdefault("num_slots", 2)
    if name == "jax":
        return JServingEngine(mdl, page_size=PS, max_model_len=MAXLEN,
                              replica=replica, **kw)
    return ServingEngine(mdl, device="cpu", page_size=PS,
                         max_model_len=MAXLEN, replica=replica, **kw)


def _server(name):
    return (jtelemetry if name == "jax" else telemetry).get_server()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), \
                resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _wait(cond, budget=60.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < budget, "condition never held"
        time.sleep(0.005)


_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*)?\})? (?P<value>\S+)$')


def _parse(text):
    """Prometheus text -> ({family: kind}, [(name, labels, value)]); every
    line must parse."""
    kinds, samples = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split(" ")
            kinds[fam] = kind
        elif line.startswith("# HELP ") or not line:
            continue
        else:
            m = _SAMPLE.match(line)
            assert m, f"unparseable sample line: {line!r}"
            float(m.group("value"))
            samples.append((m.group(1), m.group(2) or "", m.group("value")))
    return kinds, samples


def _families_of(text, replica):
    kinds, samples = _parse(text)
    fams = set()
    for name, labels, _ in samples:
        if f'replica="{replica}"' not in labels:
            continue
        fam = re.sub(r"_(bucket|sum|count)$", "", name) \
            if re.sub(r"_(bucket|sum|count)$", "", name) in kinds else name
        fams.add(fam)
    return {f for f in fams if f.startswith("serving_")
            and not f.endswith("_traces") and f != "serving_ttft_cold_seconds"}


@pytest.fixture(scope="module")
def scraped(jax_model, model):
    """One engine per package with telemetry_port=0, the same requests,
    each endpoint scraped mid-run (a request held at a wedge) and after."""
    out = {}
    for name, mdl in (("jax", jax_model), ("torch", model)):
        rep = f"{name[0]}-tel"
        eng = _engine(name, mdl, rep, telemetry_port=0)
        f = jfaults if name == "jax" else faults
        with eng:
            eng.generate(_prompt(5, 1), max_new_tokens=4, timeout=300)
            srv = _server(name)
            site = f"serving.scheduler_wedge@{rep}"
            f.inject(site, seconds=30.0, times=1)
            _wait(lambda: f.trip_count(site) >= 1)
            h = eng.submit(_prompt(9, 2), max_new_tokens=5)
            mid = {p: _get(srv.url + p) for p in ("/statusz", "/metrics")}
            f.clear(site)
            h.result(timeout=300)
            after = {p: _get(srv.url + p)
                     for p in ("/metrics", "/healthz", "/statusz", "/nope")}
        out[name] = (rep, mid, after, srv.port)
        (jtelemetry if name == "jax" else telemetry).shutdown()
    return out


def test_metrics_parse_and_list_the_jax_families(scraped):
    fams = {}
    for name, (rep, mid, after, _) in scraped.items():
        code, ctype, body = after["/metrics"]
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        fams[name] = _families_of(body.decode(), rep)
    assert fams["torch"] == fams["jax"]
    assert {"serving_ttft_seconds", "serving_inter_token_seconds",
            "serving_tokens_generated", "serving_requests",
            "serving_queue_depth", "serving_pool_bytes"} <= fams["torch"]


def test_metrics_mid_run_show_the_queued_request(scraped):
    for name, (rep, mid, _, _) in scraped.items():
        code, _, body = mid["/metrics"]
        assert code == 200
        _, samples = _parse(body.decode())
        sub = [s for s in samples if s[0] == "serving_requests"
               and f'replica="{rep}"' in s[1] and "submitted" in s[1]]
        assert sub and float(sub[0][2]) == 2.0, name


def test_statusz_keys_match_the_reference(scraped):
    docs = {name: json.loads(v[2]["/statusz"][2])
            for name, v in scraped.items()}
    j, t = docs["jax"], docs["torch"]
    top = {"time", "rank", "pid", "tracing_active", "in_flight_spans",
           "last_flight_record", "flight_recorder_armed", "faults",
           "collective_watchdog", "memory"}
    assert top <= j.keys() and top <= t.keys()
    assert t["collective_watchdog"] is None
    js, ts = j["serving/j-tel"], t["serving/t-tel"]
    assert js.keys() - ts.keys() <= _LEFT_OUT, js.keys() - ts.keys()
    assert js["memory"].keys() - ts["memory"].keys() == set()
    assert ts["mp"] == js["mp"] == 1
    assert ts["memory"]["pool_shard_bytes_by_dtype"] \
        == js["memory"]["pool_shard_bytes_by_dtype"]
    for k in ("num_slots", "num_pages", "bytes_per_page", "kv_dtype",
              "pool_dtype", "started"):
        assert ts[k] == js[k], k
    assert ts["memory"]["fixed_bytes"] == js["memory"]["fixed_bytes"]
    assert ts["memory"]["pool_bytes_by_dtype"] \
        == js["memory"]["pool_bytes_by_dtype"]
    assert [r["owner"] for r in t["memory"]["owners"]][-1] == "untracked"


def test_statusz_mid_run_shows_the_slot_table(scraped):
    for name, (rep, mid, _, _) in scraped.items():
        sec = json.loads(mid["/statusz"][2])[f"serving/{rep}"]
        assert sec["queue_depth"] == 1 and len(sec["slots"]) == 2, name
        assert sec["health"]["state"] == "healthy"


def test_unknown_path_404_and_scrape_histogram(scraped):
    for name, (_, _, after, _) in scraped.items():
        code, _, body = after["/nope"]
        assert code == 404
        assert json.loads(body)["endpoints"] == ["/metrics", "/healthz",
                                                 "/statusz"]
    h = metrics.get_registry().get("telemetry.scrape_seconds")
    assert h.labels(path="/metrics").count >= 2
    assert h.labels(path="other").count >= 1


def test_server_stops_with_the_engine_that_started_it(scraped):
    port = scraped["torch"][3]
    assert telemetry.get_server() is None
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


def _health_states(name, mdl, gating):
    """(state, http code, top status, component) through healthy,
    degraded (queue pressure while wedged) and draining."""
    rep = f"{name[0]}-hz-{int(gating)}"
    eng = _engine(name, mdl, rep, telemetry_port=0, max_queue=2,
                  health_gating=gating)
    f = jfaults if name == "jax" else faults
    out = []

    def read():
        code, _, body = _get(_server(name).url + "/healthz")
        doc = json.loads(body)
        comp = doc["components"][f"serving/{rep}"]
        out.append((comp["state"], code, doc["status"],
                    comp.get("gating", True)))

    with eng:
        eng.generate(_prompt(4, 3), max_new_tokens=2, timeout=300)
        read()
        site = f"serving.scheduler_wedge@{rep}"
        f.inject(site, seconds=30.0, times=1)
        _wait(lambda: f.trip_count(site) >= 1)
        h = eng.submit(_prompt(6, 4), max_new_tokens=3)
        read()
        eng.begin_drain()
        read()
        f.clear(site)
        h.result(timeout=300)
    return out


@pytest.mark.parametrize("gating", [True, False], ids=["gating", "non-gating"])
def test_healthz_codes_equal_jax(jax_model, model, gating):
    want = _health_states("jax", jax_model, gating)
    jtelemetry.shutdown()
    got = _health_states("torch", model, gating)
    assert got == want
    states = [g[0] for g in got]
    assert states == ["healthy", "degraded", "draining"]
    if gating:
        assert [g[1:3] for g in got] == [(200, "ok"), (200, "degraded"),
                                         (503, "draining")]
    else:
        assert all(g[1:] == (200, "ok", False) for g in got)


def test_port_in_use_logs_and_serves_on(model, caplog):
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        port = busy.getsockname()[1]
        eng = _engine("torch", model, "t-tel-busy", telemetry_port=port)
        with caplog.at_level(logging.ERROR,
                             logger="paddle_tpu_torch.observability"):
            with eng:
                out = eng.generate(_prompt(5, 5), max_new_tokens=3,
                                   timeout=300)
                assert eng.telemetry is None
    assert len(out) == 3
    assert any("telemetry endpoint not started" in r.getMessage()
               for r in caplog.records)
    assert telemetry.get_server() is None


def test_env_port_and_shared_server(model, monkeypatch):
    """PADDLE_TELEMETRY_PORT starts the server; a second engine shares
    it, keeps its own sections, and the server stays up until the last
    engine's section is gone."""
    monkeypatch.setenv("PADDLE_TELEMETRY_PORT", "0")
    a = _engine("torch", model, "t-tel-a")
    b = _engine("torch", model, "t-tel-b")
    with a:
        srv = a.telemetry
        assert srv is not None and srv.port
        with b:
            assert b.telemetry is srv
            sz = json.loads(_get(srv.url + "/statusz")[2])
            assert {"serving/t-tel-a", "serving/t-tel-b"} <= sz.keys()
        sz = json.loads(_get(srv.url + "/statusz")[2])
        assert "serving/t-tel-b" not in sz and "serving/t-tel-a" in sz
    assert telemetry.get_server() is None


def test_remove_providers_only_if_owner():
    def s1():
        return {"a": 1}

    def s2():
        return {"a": 2}

    telemetry.add_status_provider("serving/x", s1)
    telemetry.add_status_provider("serving/x", s2)      # a newer owner
    telemetry.remove_providers_if_owner("serving/x", status_fn=s1)
    assert telemetry._PROVIDERS["serving/x"] is s2
    telemetry.remove_providers_if_owner("serving/x", status_fn=s2)
    assert "serving/x" not in telemetry._PROVIDERS


def test_health_fold_and_provider_errors():
    srv = telemetry.serve(0)

    def broken():
        raise RuntimeError("provider down")

    try:
        telemetry.add_health_provider("c/ok", lambda: {"state": "healthy",
                                                       "reasons": []})
        telemetry.add_health_provider("c/bad", broken, gating=False)
        code, _, body = _get(srv.url + "/healthz")
        doc = json.loads(body)
        assert code == 200 and doc["status"] == "ok"
        assert doc["components"]["c/bad"]["state"] == "error"
        telemetry.add_health_provider("c/bad", broken)          # now gating
        code, _, body = _get(srv.url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "error"
        telemetry.add_status_provider("c/st", broken)
        sz = json.loads(_get(srv.url + "/statusz")[2])
        assert "provider down" in sz["c/st"]["error"]
    finally:
        for k in ("c/ok", "c/bad"):
            telemetry.remove_health_provider(k)
        telemetry.remove_status_provider("c/st")
    assert telemetry.serve(0) is srv             # one server per process
