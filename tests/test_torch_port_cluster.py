"""PyTorch port, cluster serving: paddle_tpu_torch's serving/cluster
(ReplicaPool, PrefixAffinityRouter, ServingCluster) and serving/qos's
AutoScaler on the CPU against the JAX package (the tiny trained GPT of
test_torch_port_serving.py, converted; page_size=8, max_model_len=64).

Mirrors tests/test_cluster.py, the router / cluster tests of
tests/test_multitenant.py and the autoscaler / cluster tests of
tests/test_qos.py:

- the router's affine replica equals the JAX router's for 500 seeded
  prompts over 1-5 replicas and after ``resize``; its decisions, seeded
  random picks and fallbacks equal JAX's;
- both packages' clusters serve the same traffic under the same faults:
  greedy ids byte-identical (after a replica loss mid-decode too), the
  same ``replica_history`` per request, the same ``cluster.*`` series;
- the autoscaler's tick script against a stub pool gives JAX's timeline
  and series; end to end, a pool scales up under pressure and drains
  back, and an injected ``cluster.replica_preempt@<r>`` is rerouted,
  reaped and replaced under a fresh id.

Every JAX engine runs under a replica prefix (and every JAX cluster under
a name) of its own: the JAX metrics registry is process-wide, and
tests/test_cluster.py and tests/test_qos.py read its series."""

import json
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving import AutoScaler as JAutoScaler
from paddle_tpu.serving import PrefixAffinityRouter as JRouter
from paddle_tpu.serving import ServingCluster as JServingCluster
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.cluster.router import routing_key as jrouting_key
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import faults, telemetry
from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.serving import (AutoScaler, PrefixAffinityRouter,
                                      ReplicaPool, RequestRejectedError,
                                      ServingCluster, ServingEngine)
from paddle_tpu_torch.serving.cluster.router import routing_key
from paddle_tpu_torch.serving.engine import EngineStoppedError
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8
MAXLEN = 64


@pytest.fixture(scope="module")
def jax_model():
    """Tiny GPT, briefly trained so greedy decode emits varied tokens
    (the recipe of tests/test_cluster.py)."""
    paddle.seed(0)
    m = JGPT(**CFG)
    o = opt.AdamW(learning_rate=1e-2, parameters=m.parameters())
    step = paddle.jit.TrainStep(m, o, loss_fn=None)
    ids = paddle.to_tensor(
        np.random.RandomState(0).randint(1, 96, (8, 20)).astype("int64"))
    for _ in range(5):
        step({"input_ids": ids, "labels": ids})
    return m.eval()


@pytest.fixture(scope="module")
def model(jax_model):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(
        m, {k: np.asarray(v._value) for k, v in jax_model.state_dict().items()})
    return m.eval()


@pytest.fixture(scope="module")
def jref(jax_model):
    """Greedy ids of one uninterrupted JAX engine (the JAX cluster tests'
    ``generate()`` reference, served: the same ids, fewer compiles)."""
    eng = JServingEngine(jax_model, num_slots=2, page_size=PS,
                         max_model_len=MAXLEN, replica="j-pcl-ref")
    eng.start()
    cache = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            cache[key] = eng.generate(prompt, max_new_tokens=n, timeout=300)
        return cache[key]

    yield ref
    eng.stop()


def _prompt(n, seed=1):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


def _affine_prompt(router, target, n, start_seed):
    for seed in range(start_seed, start_seed + 500):
        p = _prompt(n, seed)
        if router.affine_index(p) == target:
            return p
    raise AssertionError(f"no prompt affine to replica {target} found")


def _healthy(i, **over):
    st = {"replica": str(i), "state": "healthy", "reasons": [],
          "stalled": False, "queue_depth": 0, "active": 0, "num_slots": 4}
    st.update(over)
    return st


def _cluster(side, mdl, name, **kw):
    """``side``'s cluster: the same name and replica ids in both packages
    (each has its own registry), never tests/test_cluster.py's."""
    kw.setdefault("replicas", 2)
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", PS)
    kw.setdefault("max_model_len", MAXLEN)
    kw.setdefault("name", name)
    kw.setdefault("replica_prefix", f"{name}/")
    if side == "jax":
        return JServingCluster(mdl, **kw)
    return ServingCluster(mdl, device="cpu", **kw)


def _cluster_series(reg, name):
    """Every ``cluster.*`` series labelled ``cluster=name``:
    {(family, labels): value}."""
    out = {}
    for m in reg.metrics():
        if not m.name.startswith("cluster."):
            continue
        for suffix, labels, val in m.samples():
            if labels.get("cluster") == name:
                out[(m.name + suffix, tuple(sorted(labels.items())))] = val
    return out


def _side(side):
    return types.SimpleNamespace(
        faults=jfaults if side == "jax" else faults,
        registry=(jmetrics if side == "jax" else metrics).get_registry())


# ================================================================= router
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_router_affine_index_equals_jax(n):
    """500 seeded prompts (and adapters) pick JAX's affine replica over 1-5
    replicas, and again after ``resize`` to n + 1 and back."""
    r, jr = PrefixAffinityRouter(n, affinity_tokens=16), \
        JRouter(n, affinity_tokens=16)
    rs = np.random.RandomState(n)
    prompts = [rs.randint(1, 50000, (int(rs.randint(1, 40)),)).tolist()
               for _ in range(500)]
    for size in (n, n + 1, n):
        r.resize(size)
        jr.resize(size)
        got = [r.affine_index(p) for p in prompts]
        assert got == [jr.affine_index(p) for p in prompts]
        assert got == [jr.affine_index(list(np.asarray(p, np.int64)))
                       for p in prompts]
        assert [r.affine_index(p, adapter=f"a{i % 7}")
                for i, p in enumerate(prompts[:50])] \
            == [jr.affine_index(p, adapter=f"a{i % 7}")
                for i, p in enumerate(prompts[:50])]
        if size > 1:
            assert len(set(got)) == size
    with pytest.raises(ValueError):
        r.resize(0)


def test_router_affinity_deterministic_and_stable():
    """Rendezvous hashing: the same prefix maps to the same replica, and
    removing one replica only moves that replica's prefixes; every
    decision equals the JAX router's."""
    r, jr = PrefixAffinityRouter(4, affinity_tokens=16), \
        JRouter(4, affinity_tokens=16)
    states = [_healthy(i) for i in range(4)]
    prompts = [_prompt(20, s) for s in range(24)]
    affines = [r.affine_index(p) for p in prompts]
    assert len(set(affines)) > 1
    for p, a in zip(prompts, affines):
        d = r.route(p, states)
        assert (d.replica, d.affine, d.hit, d.reason) \
            == (a, a, True, "affinity")
        assert r.affine_index(list(p[:16]) + [7, 7, 7]) == a
    lost = affines[0]
    states[lost]["state"] = "error"
    for p, a in zip(prompts, affines):
        d, jd = r.route(p, states), jr.route(p, states)
        assert (d.replica, d.affine, d.hit, d.reason) \
            == (jd.replica, jd.affine, jd.hit, jd.reason)
        assert d.affine == a
        if a == lost:
            assert d.replica != lost and d.reason == "fallback_unroutable"
        else:
            assert d.replica == a and d.reason == "affinity"


def test_router_policies_and_validation():
    for bad in (lambda m: m(0), lambda m: m(2, policy="bogus")):
        with pytest.raises(ValueError) as e1:
            bad(PrefixAffinityRouter)
        with pytest.raises(ValueError) as e2:
            bad(JRouter)
        assert str(e1.value) == str(e2.value)
    states = [_healthy(0), _healthy(1), _healthy(2)]
    r = PrefixAffinityRouter(3, policy="round_robin")
    assert [r.route(_prompt(8, 1), states).replica for _ in range(4)] \
        == [0, 1, 2, 0]
    r, jr = PrefixAffinityRouter(3, policy="random", seed=3), \
        JRouter(3, policy="random", seed=3)
    picks = [r.route(_prompt(8, 1), states).replica for _ in range(32)]
    assert picks == [jr.route(_prompt(8, 1), states).replica
                     for _ in range(32)]
    assert set(picks) == {0, 1, 2}
    r = PrefixAffinityRouter(3, policy="least_loaded")
    d = r.route(_prompt(8, 1), [_healthy(0, active=2), _healthy(1, active=1),
                                _healthy(2, queue_depth=3)])
    assert (d.replica, d.reason) == (1, "least_loaded")
    with pytest.raises(ValueError):
        r.route(_prompt(8, 1), states[:1])


def test_router_sheds_and_falls_back():
    r, jr = PrefixAffinityRouter(2, affinity_tokens=16), \
        JRouter(2, affinity_tokens=16)
    p = _affine_prompt(r, 0, 20, 100)
    assert r.route(p, [_healthy(0, state="stopped"),
                       _healthy(1, state="error")]) is None
    for states, want in (
            ([_healthy(0, queue_depth=9), _healthy(1)],
             (1, False, "fallback_saturated")),
            ([_healthy(0, stalled=True), _healthy(1)],
             (1, False, "fallback_saturated")),
            ([_healthy(0, state="degraded"), _healthy(1)],
             (0, True, "affinity"))):
        d, jd = r.route(p, states), jr.route(p, states)
        assert (d.replica, d.hit, d.reason) == want \
            == (jd.replica, jd.hit, jd.reason)


def test_router_deepest_match_equals_jax():
    """Radix summaries steer the affinity policy to the deepest resident
    match, as the JAX router does (digests from each package's own
    ``prefix_digest``)."""
    from paddle_tpu.serving.prefix_index import prefix_digest as jdigest
    from paddle_tpu_torch.serving.prefix_index import prefix_digest

    p = _prompt(33, 5)
    assert [prefix_digest(p[:k]) for k in (8, 16, 24)] \
        == [jdigest(p[:k]) for k in (8, 16, 24)]
    summ = {"page_size": 8, "digests": [prefix_digest(p[:8]),
                                        prefix_digest(p[:16])]}
    r, jr = PrefixAffinityRouter(3, affinity_tokens=16), \
        JRouter(3, affinity_tokens=16)
    affine = r.affine_index(p)
    deep = (affine + 1) % 3
    states = [_healthy(i, prefix_index=summ if i == deep else None)
              for i in range(3)]
    d, jd = r.route(p, states), jr.route(p, states)
    assert (d.replica, d.reason, d.prefix_pages) == (deep, "prefix_match", 2) \
        == (jd.replica, jd.reason, jd.prefix_pages)


def test_router_adapter_affinity():
    """Adapter-named requests rendezvous on the adapter key: every prompt
    of one tenant lands on one replica; the two key namespaces cannot
    collide; prefix routing is untouched without an adapter."""
    r = PrefixAffinityRouter(4, affinity_tokens=16)
    states = [_healthy(i) for i in range(4)]
    prompts = [_prompt(20, s) for s in range(12)]
    a_target = r.affine_index(prompts[0], adapter="tenant-a")
    assert a_target == JRouter(4, affinity_tokens=16).affine_index(
        prompts[0], adapter="tenant-a")
    for p in prompts:
        assert r.affine_index(p, adapter="tenant-a") == a_target
        d = r.route(p, states, adapter="tenant-a")
        assert d.replica == a_target and d.reason == "affinity"
    assert len({r.affine_index(prompts[0], adapter=f"tn{i}")
                for i in range(16)}) > 1
    assert routing_key([1, 2], 16, "x") != routing_key([1, 2], 16)
    assert routing_key([1, 2], 16, "x") == jrouting_key([1, 2], 16, "x")
    assert r.route(prompts[0], states).affine == r.affine_index(prompts[0])


# =================================================================== pool
def test_pool_placement():
    """``devices="auto"`` is every visible card (raises without one), an
    explicit list is taken as given, ``mp=`` carves the visible cards
    (raises without one) and 1-device submeshes are plain replicas (the
    mesh engines themselves: ``test_torch_port_serving_mp.py``); ids are
    monotonic under add / remove."""
    mdl = GPTForCausalLM(device="cpu", **CFG)
    if not torch.cuda.is_available():
        for kw in ({"devices": "auto"}, {"mp": 2}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ReplicaPool(mdl, page_size=PS, max_model_len=MAXLEN, **kw)
    subs = ReplicaPool(mdl, devices=[["cpu"], ["cpu"]], page_size=PS,
                       max_model_len=MAXLEN, replica_prefix="sub/")
    assert subs.meshes == [[torch.device("cpu")]] * 2
    assert [e.stats()["mp"] for e in subs.engines] == [1, 1]
    pool = ReplicaPool(mdl, devices=["cpu", "cpu"], page_size=PS,
                       max_model_len=MAXLEN, replica_prefix="pp/")
    assert len(pool) == 2 and pool.replica_ids == ["pp/0", "pp/1"]
    assert all(e.device == torch.device("cpu") for e in pool.engines)
    e2 = pool.add_replica()
    pool.remove_replica(pool.engines[0])
    assert pool.replica_ids == ["pp/1", "pp/2"] and e2.replica == "pp/2"
    engines, states = pool.snapshot_states()
    assert [st["replica"] for st in states] == ["pp/1", "pp/2"]
    assert states[0]["state"] == "stopped" and states[0]["num_slots"] == 4


def test_two_engines_distinct_metric_series(model):
    """The registry keeps one ``serving.*`` series per replica."""
    c = metrics.counter("serving.requests")
    t = metrics.counter("serving.tokens_generated")
    pool = ReplicaPool(model, replicas=2, device="cpu", num_slots=1,
                       page_size=PS, max_model_len=MAXLEN,
                       replica_prefix="pds/")
    with pool:
        e0, e1 = pool.engines
        assert pool.replica_ids == ["pds/0", "pds/1"]
        e0.generate(_prompt(6, 30), max_new_tokens=3, timeout=300)
        e1.generate(_prompt(7, 31), max_new_tokens=3, timeout=300)
        e1.generate(_prompt(5, 32), max_new_tokens=3, timeout=300)
    assert c.get(status="completed", replica="pds/0") == 1
    assert c.get(status="completed", replica="pds/1") == 2
    assert t.get(replica="pds/0") == 3 and t.get(replica="pds/1") == 6
    prom = metrics.get_registry().to_prometheus()
    assert 'serving_requests{replica="pds/0",status="completed"}' in prom
    assert 'serving_requests{replica="pds/1",status="completed"}' in prom


def test_statusz_providers_keyed_per_replica(model):
    """Two engines register ``serving/<replica>`` providers; stopping one
    unregisters only its own."""
    e0 = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                       max_model_len=MAXLEN, replica="ps0", telemetry_port=0)
    e1 = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                       max_model_len=MAXLEN, replica="ps1", telemetry_port=0)
    e0.start()
    try:
        e1.start()
        try:
            for k in ("serving/ps0", "serving/ps1"):
                assert k in telemetry._PROVIDERS
                assert k in telemetry._HEALTH_PROVIDERS
            with urllib.request.urlopen(
                    telemetry._SERVER.url + "/statusz", timeout=10) as r:
                sz = json.loads(r.read().decode())
            assert sz["serving/ps0"]["replica"] == "ps0"
            assert sz["serving/ps1"]["replica"] == "ps1"
        finally:
            e1.stop()
        assert "serving/ps1" not in telemetry._PROVIDERS
        assert "serving/ps1" not in telemetry._HEALTH_PROVIDERS
        assert "serving/ps0" in telemetry._PROVIDERS
    finally:
        e0.stop()
        telemetry.shutdown()
    assert "serving/ps0" not in telemetry._PROVIDERS


# ======================================================= cluster behavior
def _run_affinity(side, mdl, name):
    s = _side(side)
    hits = s.registry.counter("serving.prefix_cache_hits")
    cluster = _cluster(side, mdl, name, prefix_sharing=True,
                       saturation_queue=32)
    with cluster:
        head = _prompt(16, 8)
        group = [head + _prompt(4, sd) for sd in range(20, 24)]
        other = _prompt(13, 9)
        hs = [cluster.submit(p, max_new_tokens=6) for p in group]
        ho = cluster.submit(other, max_new_tokens=6)
        res = [h.result(timeout=300) for h in hs] + [ho.result(timeout=300)]
        hist = [h.replica_history for h in hs + [ho]]
        st = cluster.stats()
        rate = cluster.affinity_hit_rate()
    rep = hist[0][0]
    return {"ids": res, "history": hist, "rate": rate,
            "hits": st["affinity"]["hits"],
            "rerouted": st["rerouted_requests"],
            "prefix_hits": hits.get(replica=rep) or 0,
            "series": _cluster_series(s.registry, name),
            "prompts": group + [other]}


def test_cluster_greedy_parity_and_prefix_affinity(model, jax_model, jref):
    """Same-prefix requests land on one replica (hit rate 1.0), the ids
    equal the JAX cluster's and an uninterrupted engine's, the affine
    replica's prefix cache hits, and the routing and every ``cluster.*``
    series equal the JAX cluster's."""
    got = _run_affinity("torch", model, "pcl-aff")
    want = _run_affinity("jax", jax_model, "pcl-aff")
    assert got["ids"] == want["ids"]
    assert got["ids"] == [jref(p, 6) for p in got["prompts"]]
    assert got["history"] == want["history"]
    assert len({h[0] for h in got["history"][:4]}) == 1
    assert got["rate"] == want["rate"] == 1.0
    assert got["hits"] == 5 and got["rerouted"] == 0
    assert got["prefix_hits"] > 0
    assert got["series"] == want["series"]
    assert got["series"][("cluster.affinity", (("cluster", "pcl-aff"),
                                               ("result", "hit")))] == 5


def test_affinity_beats_random_on_prefix_cache_hits(model):
    """On one mixed-prefix workload, affinity routing gives more
    prefix-cache hits than the random control, and the same ids."""
    hits = metrics.counter("serving.prefix_cache_hits")

    def run(policy):
        name = f"pcl-pol-{policy}"
        reps = (f"{name}/0", f"{name}/1")
        cluster = _cluster("torch", model, name, prefix_sharing=True,
                           policy=policy, seed=7, saturation_queue=32)
        with cluster:
            heads = [_prompt(16, 60 + g) for g in range(3)]
            prompts = [heads[i % 3] + _prompt(4, 70 + i) for i in range(12)]
            hs = [cluster.submit(p, max_new_tokens=4) for p in prompts]
            res = [h.result(timeout=300) for h in hs]
            rate = cluster.affinity_hit_rate()
        return sum(hits.get(replica=r) or 0 for r in reps), rate, res

    aff_hits, aff_rate, aff_res = run("affinity")
    rnd_hits, rnd_rate, rnd_res = run("random")
    assert aff_res == rnd_res
    assert aff_rate == 1.0 and rnd_rate < 1.0
    assert aff_hits > rnd_hits


def test_wedged_replica_falls_back_least_loaded(model, jref):
    """A wedged replica stops receiving its affine traffic: the router
    reads ``scheduler_stalled`` and falls back to the survivor."""
    cluster = _cluster("torch", model, "pcl-wedge", prefix_sharing=True,
                       degraded_stall_s=0.2)
    with cluster:
        for e in cluster.engines:
            e.generate(_prompt(4, 40), max_new_tokens=2, timeout=300)
        p0 = _affine_prompt(cluster.router, 0, 20, 200)
        faults.inject("serving.scheduler_wedge@pcl-wedge/0", seconds=2.0,
                      times=1)
        try:
            h_wedged = cluster.submit(p0, max_new_tokens=8)
            t0 = time.time()
            while time.time() - t0 < 30:
                st = cluster.engines[0].health_state()
                if st["state"] == "degraded" and any(
                        "scheduler_stalled" in r for r in st["reasons"]):
                    break
                time.sleep(0.02)
            else:
                raise AssertionError("replica 0 never reported stalled")
            p_var = list(p0[:16]) + _prompt(4, 41)
            assert cluster.router.affine_index(p_var) == 0
            h2 = cluster.submit(p_var, max_new_tokens=4)
            assert h2.result(timeout=300) == jref(p_var, 4)
            assert h2.replica_history == ["pcl-wedge/1"]
        finally:
            faults.clear()
        assert h_wedged.result(timeout=300) == jref(p0, 8)
        assert h_wedged.replica_history == ["pcl-wedge/0"]
        assert cluster.stats()["rerouted_requests"] == 0


# ================================================== cross-replica requeue
def _run_replica_loss(side, mdl, name):
    s = _side(side)
    cluster = _cluster(side, mdl, name, prefix_sharing=True)
    with cluster:
        for e in cluster.engines:
            e.generate(_prompt(4, 50), max_new_tokens=2, timeout=300)
        pa = _affine_prompt(cluster.router, 0, 7, 300)
        pb = _affine_prompt(cluster.router, 0, 10, 400)
        crash = {"armed": True}

        def bug():
            # fire on engine state (both requests co-resident on replica 0
            # with two tokens each), pacing the scheduler until B lands
            slots = [x for x in cluster.engines[0]._slots if x is not None]
            if not crash["armed"]:
                return
            if len(slots) < 2:
                time.sleep(0.001)
                return
            if all(x.produced >= 2 for x in slots):
                crash["armed"] = False
                raise ValueError("injected fatal replica crash")

        s.faults.inject(f"serving.step_crash@{name}/0", fn=bug)
        try:
            ha = cluster.submit(pa, max_new_tokens=14)
            hb = cluster.submit(pb, max_new_tokens=12)
            ids = [ha.result(timeout=300), hb.result(timeout=300)]
        finally:
            s.faults.clear()
        out = {"ids": ids, "prompts": (pa, pb),
               "status": (ha.status, hb.status),
               "history": [ha.replica_history, hb.replica_history],
               "dead": cluster.engines[0].health,
               "rerouted": cluster.stats()["rerouted_requests"]}
        h3 = cluster.submit(_affine_prompt(cluster.router, 0, 6, 500),
                            max_new_tokens=4)
        out["ids"].append(h3.result(timeout=300))
        out["history"].append(h3.replica_history)
        out["health"] = cluster.health
    out["series"] = _cluster_series(s.registry, name)
    return out


def test_replica_loss_mid_decode_reroutes_greedy_identical(model, jax_model,
                                                           jref):
    """A fatal ``serving.step_crash@<r>`` kills replica 0 mid-decode in
    both packages' clusters; its in-flight requests reroute onto replica 1
    as prompt + tokens-so-far.  Ids equal an uninterrupted run's and the
    JAX cluster's, with the same histories and ``cluster.*`` series."""
    got = _run_replica_loss("torch", model, "pcl-loss")
    want = _run_replica_loss("jax", jax_model, "pcl-loss")
    pa, pb = got["prompts"]
    assert got["ids"][:2] == [jref(pa, 14), jref(pb, 12)]
    assert got["ids"] == want["ids"]
    assert got["status"] == ("completed", "completed")
    assert got["history"] == want["history"] == [
        ["pcl-loss/0", "pcl-loss/1"], ["pcl-loss/0", "pcl-loss/1"],
        ["pcl-loss/1"]]
    assert got["dead"] == want["dead"] == "error"
    assert got["rerouted"] == want["rerouted"] == 2
    assert got["health"] == "healthy"
    assert got["series"] == want["series"]
    assert got["series"][("cluster.rerouted_requests",
                          (("cluster", "pcl-loss"),))] == 2


def test_replica_stop_mid_decode_reroutes(model, jref):
    """A plain ``stop()`` of a replica mid-decode reroutes the same way."""
    cluster = _cluster("torch", model, "pcl-stop")
    with cluster:
        for e in cluster.engines:
            e.generate(_prompt(4, 55), max_new_tokens=2, timeout=300)
        pa = _affine_prompt(cluster.router, 0, 8, 600)
        ha = cluster.submit(pa, max_new_tokens=24)
        t0 = time.time()
        while len(ha.token_ids) < 2 and time.time() - t0 < 60:
            time.sleep(0.001)
        assert len(ha.token_ids) >= 2, "no tokens before the kill"
        cluster.engines[0].stop()
        assert ha.result(timeout=300) == jref(pa, 24)
        assert ha.replica_history[0] == "pcl-stop/0"
        assert ha.replica_history[-1] == "pcl-stop/1"


def test_cluster_sheds_when_nothing_routable(model):
    rejected = metrics.counter("cluster.rejected")
    cluster = _cluster("torch", model, "pcl-shed", num_slots=1)
    with cluster:
        cluster.generate(_prompt(5, 90), max_new_tokens=2, timeout=300)
        for e in cluster.engines:
            e.stop()
        with pytest.raises(RequestRejectedError) as ei:
            cluster.submit(_prompt(5, 91), max_new_tokens=2)
        assert ei.value.reason == "no_routable_replica"
        assert rejected.get(reason="no_routable_replica",
                            cluster="pcl-shed") == 1
        assert cluster.health == "stopped"


def test_cluster_stop_fails_inflight_fast_without_reroute(model, jref):
    """A cluster ``stop()`` fails in-flight handles fast, never rerouted;
    a drain-stop finishes them."""
    cluster = _cluster("torch", model, "pcl-halt", num_slots=1)
    cluster.start()
    cluster.generate(_prompt(4, 95), max_new_tokens=2, timeout=300)
    h = cluster.submit(_prompt(8, 96), max_new_tokens=30)
    t0 = time.time()
    while len(h.token_ids) < 1 and time.time() - t0 < 60:
        time.sleep(0.001)
    cluster.stop()
    with pytest.raises(EngineStoppedError):
        h.result(timeout=10)
    assert cluster.stats()["rerouted_requests"] == 0
    cluster2 = _cluster("torch", model, "pcl-halt2", num_slots=1)
    cluster2.start()
    p = _prompt(6, 97)
    h2 = cluster2.submit(p, max_new_tokens=5)
    cluster2.stop(drain=True)
    assert h2.result(timeout=10) == jref(p, 5)


def test_healthz_cluster_gates_replica_components(model):
    """One dead replica of two does not 503 the process: replica
    components register non-gating, the cluster's component gates."""
    cluster = _cluster("torch", model, "pcl-hz", num_slots=1,
                       replica_prefix="", telemetry_port=0)
    try:
        with cluster:
            cluster.generate(_prompt(5, 85), max_new_tokens=2, timeout=300)
            code, doc = telemetry._SERVER._healthz()
            assert code == 200
            assert doc["components"]["serving/0"].get("gating") is False
            assert doc["components"]["serving/1"].get("gating") is False
            key = "cluster/pcl-hz"
            assert doc["components"][key]["state"] == "healthy"
            cluster.engines[0].stop()
            code, doc = telemetry._SERVER._healthz()
            assert code == 200
            assert doc["components"][key]["state"] == "healthy"
        eng = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                            max_model_len=MAXLEN, replica="pcl-solo",
                            telemetry_port=0)
        eng.start()
        try:
            code, doc = telemetry._SERVER._healthz()
            assert doc["components"]["serving/pcl-solo"].get("gating") is None
        finally:
            eng.stop()
    finally:
        telemetry.shutdown()


def test_cluster_statusz_section_and_cancel(model):
    cluster = ServingCluster(model, replicas=2, device="cpu", num_slots=2,
                             page_size=PS, max_model_len=MAXLEN,
                             replica_prefix="pcl-sz/")
    with cluster:
        # the name comes from the replica prefix, the provider key from it
        assert cluster.name == "pcl-sz"
        assert "cluster/pcl-sz" in telemetry._PROVIDERS
        cluster.generate(_prompt(5, 98), max_new_tokens=3, timeout=300)
        sz = cluster._statusz()
        assert set(sz["replica_health"]) == {"pcl-sz/0", "pcl-sz/1"}
        for rep in sz["replica_health"].values():
            assert {"state", "queue_depth", "occupancy",
                    "page_utilization"} <= set(rep)
        assert sz["health"]["state"] == "healthy"
        assert sz["affinity"]["hits"] + sz["affinity"]["misses"] >= 1
        assert set(sz["memory"]) == {"pcl-sz/0", "pcl-sz/1"}
        h = cluster.submit(_prompt(8, 99), max_new_tokens=40)
        h.cancel()
        toks = h.result(timeout=60)
        assert h.status == "cancelled" and len(toks) < 40
    assert "cluster/pcl-sz" not in telemetry._PROVIDERS


def test_cluster_route_spans_carry_the_decision(model):
    from paddle_tpu_torch.observability import tracing

    tr = tracing.Tracer().start()
    try:
        cluster = _cluster("torch", model, "pcl-span")
        with cluster:
            for s in range(3):
                cluster.generate(_prompt(6, 110 + s), max_new_tokens=3,
                                 timeout=300)
    finally:
        tr.stop()
    spans = tr.find("cluster.route")
    assert len(spans) == 3
    for sp in spans:
        assert {"affine", "hit", "reason", "policy", "replica",
                "leg"} <= set(sp.attrs)
        assert isinstance(sp.attrs["hit"], bool)


def test_cluster_multitenant_adapter_affinity_e2e(model):
    """Two replicas over one shared ``LoRAStore``: a tenant's requests land
    on its affine replica with a dedicated engine's ids; embed requests
    ride the cluster."""
    from paddle_tpu_torch.serving.multitenant import (LoRAAdapter, LoRAStore,
                                                      MultiTenantEngine)

    store = LoRAStore(model, capacity=4, ranks=(4,),
                      targets=("qkv", "out_proj"))
    for i in range(2):
        store.register(LoRAAdapter.random(model, f"t{i}", rank=4,
                                          seed=20 + i, scale=0.6))
    prompts = [_prompt(6, 60 + i) for i in range(3)]
    eng = MultiTenantEngine(model, lora_store=store, device="cpu",
                            num_slots=2, page_size=PS, max_model_len=MAXLEN,
                            replica="pcl-mt-ded")
    with eng:
        refs = [eng.generate(p, max_new_tokens=6, adapter="t0", timeout=600)
                for p in prompts]
    cluster = _cluster("torch", model, "pcl-mt", lora_store=store)
    with cluster:
        target = cluster.router.affine_index([], adapter="t0")
        assert all(type(e).__name__ == "MultiTenantEngine"
                   for e in cluster.engines)
        for p, ref in zip(prompts, refs):
            h = cluster.submit(p, max_new_tokens=6, adapter="t0")
            assert h.result(timeout=600) == ref
            assert h.replica_history == [f"pcl-mt/{target}"]
        he = cluster.submit(prompts[0], mode="embed")
        assert np.asarray(he.result(timeout=600)).shape == (32,)
        with pytest.raises(ValueError):
            _cluster("torch", model, "pcl-mt2").register_adapter(
                LoRAAdapter.random(model, "t9", rank=4, seed=9))


# ============================================================ autoscaler
class _StubEngine:
    def __init__(self, replica):
        self.replica = replica
        self.state = "healthy"
        self.queue_depth = 0
        self.active = 0
        self.num_slots = 4
        self.quiescent = False
        self.stopped = False

    def health_state(self):
        return {"state": self.state, "reasons": []}

    def begin_drain(self):
        self.state = "draining"

    def stop(self, **kw):
        self.stopped = True
        if self.state != "error":
            self.state = "stopped"


class _StubPool:
    def __init__(self, n):
        self._next = 0
        self.engines = []
        for _ in range(n):
            self.add_replica()

    def add_replica(self):
        e = _StubEngine(str(self._next))
        self._next += 1
        self.engines.append(e)
        return e

    def remove_replica(self, engine):
        self.engines = [e for e in self.engines if e is not engine]

    def snapshot_states(self):
        engines = list(self.engines)
        return engines, [{
            "replica": e.replica, "state": e.state, "reasons": [],
            "stalled": False, "queue_depth": e.queue_depth,
            "active": e.active, "num_slots": e.num_slots,
        } for e in engines]

    def __len__(self):
        return len(self.engines)


def test_autoscaler_validation():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2}):
        with pytest.raises(ValueError) as e1:
            AutoScaler(_StubPool(1), **kw)
        with pytest.raises(ValueError) as e2:
            JAutoScaler(_StubPool(1), **kw)
        assert str(e1.value) == str(e2.value)


def _hysteresis_script(cls, reg, name):
    pool = _StubPool(1)
    sc = cls(pool, min_replicas=1, max_replicas=3, scale_up_queue=4.0,
             scale_down_occupancy=0.25, stable_s=1.0, cooldown_s=5.0,
             interval_s=0.0, cluster=name)
    out = []
    pool.engines[0].queue_depth = 10
    out += [sc.tick(now=0.0), sc.tick(now=0.5), len(pool),
            sc.tick(now=1.0), len(pool)]
    pool.engines[1].queue_depth = 10
    out += [sc.tick(now=2.2), len(pool), sc.tick(now=6.5), len(pool)]
    for e in pool.engines:
        e.queue_depth = 0
        e.active = 0
    out += [sc.tick(now=7.0), sc.tick(now=12.0)]
    victim = sc.retiring
    out += [victim is pool.engines[-1], victim.state, len(pool),
            sc.tick(now=12.1), sc.retiring is victim]
    victim.quiescent = True
    out += [sc.tick(now=12.2), sc.retiring, victim.stopped, len(pool)]
    return out, sc.timeline(), _cluster_series(reg, name)


def test_autoscaler_hysteresis_cooldown_drain():
    """Deterministic ticks: an up signal must hold ``stable_s``, cooldown
    separates events, scale-down is drain-then-retire; the port's answers,
    timeline and series equal JAX's."""
    got = _hysteresis_script(AutoScaler, metrics.get_registry(), "pcl-as-a")
    want = _hysteresis_script(JAutoScaler, jmetrics.get_registry(),
                              "pcl-as-a")
    assert got == want
    assert got[0] == [None, None, 1, "up", 2, None, 2, "up", 3, None, None,
                      True, "draining", 3, None, True, "down", None, True, 2]
    assert [r["event"] for r in got[1]] == ["up", "up", "drain", "down"]
    assert got[2][("cluster.scale_events",
                   (("cluster", "pcl-as-a"), ("direction", "up")))] == 2


def _reap_script(cls, reg, name):
    pool = _StubPool(2)
    sc = cls(pool, min_replicas=2, max_replicas=3, stable_s=1.0,
             cooldown_s=5.0, interval_s=0.0, cluster=name)
    out = [sc.tick(now=0.0)]
    pool.engines[0].state = "error"
    out += [sc.tick(now=0.1), [e.replica for e in pool.engines]]
    return out, sc.timeline(), _cluster_series(reg, name)


def test_autoscaler_reaps_dead_and_replaces_to_min():
    got = _reap_script(AutoScaler, metrics.get_registry(), "pcl-as-b")
    want = _reap_script(JAutoScaler, jmetrics.get_registry(), "pcl-as-b")
    assert got == want
    assert got[0] == [None, "reap", ["1", "2"]]
    assert [r["event"] for r in got[1]] == ["reap", "up"]
    assert got[2][("cluster.replicas",
                   (("cluster", "pcl-as-b"), ("state", "healthy")))] == 2


def test_replica_preempt_fault_site_is_fatal(model, jax_model):
    """``cluster.replica_preempt@<r>`` kills that replica fatally in both
    packages: the in-flight handle errors, no in-place restart."""
    causes = []
    for side, mdl in (("torch", model), ("jax", jax_model)):
        s = _side(side)
        kw = dict(num_slots=2, page_size=PS, max_model_len=MAXLEN,
                  replica="pcl-victim")
        eng = ServingEngine(mdl, device="cpu", **kw) if side == "torch" \
            else JServingEngine(mdl, **kw)
        with eng:
            eng.generate(_prompt(4, 65), max_new_tokens=2, timeout=300)
            s.faults.inject("cluster.replica_preempt@pcl-victim", times=1)
            try:
                h = eng.submit(_prompt(5, 66), max_new_tokens=8)
                with pytest.raises(RuntimeError,
                                   match="serving engine failed") as ei:
                    h.result(timeout=300)
            finally:
                s.faults.clear()
            causes.append(str(ei.value.__cause__))
            assert h.status == "error" and eng.health == "error"
            assert eng._engine_restarts == 0
    assert causes[0] == causes[1]
    assert "replica pcl-victim lost" in causes[0]


def test_cluster_autoscales_up_then_down(model):
    """Queue pressure grows the pool (warm), every request completes, and
    the idle fleet drains back to ``min_replicas``: up, drain, down."""
    cluster = _cluster(
        "torch", model, "pcl-asu", replicas=1, qos=True,
        autoscale={"min_replicas": 1, "max_replicas": 3,
                   "scale_up_queue": 1.0, "scale_up_occupancy": 0.5,
                   "stable_s": 0.05, "cooldown_s": 0.2, "interval_s": 0.02})
    with cluster:
        hs, t0, i = [], time.time(), 0
        while "up" not in [r["event"]
                           for r in cluster.autoscaler.timeline()]:
            assert time.time() - t0 < 60, cluster.autoscaler.timeline()
            hs.append(cluster.submit(_prompt(4 + i % 3, 20 + i),
                                     max_new_tokens=40, tier="standard"))
            i += 1
            time.sleep(0.005)
        for h in hs:
            assert h.result(timeout=300)
        assert all(h.status == "completed" for h in hs)
        t0 = time.time()
        while len(cluster.pool) > 1 or cluster.autoscaler.retiring:
            assert time.time() - t0 < 120, cluster.autoscaler.timeline()
            time.sleep(0.01)
        events = [r["event"] for r in cluster.autoscaler.timeline()]
        assert events.index("up") < events.index("drain") \
            < events.index("down")
        st = cluster._statusz()
        assert st["autoscaler"]["min_replicas"] == 1
        assert st["autoscaler"]["timeline"]


def test_cluster_reroutes_and_reaps_killed_replica(model, jref):
    """An injected replica loss mid-traffic: every request completes with
    uninterrupted ids, the autoscaler reaps the dead replica and replaces
    it under a fresh id."""
    cluster = _cluster(
        "torch", model, "pcl-reap", qos=True,
        autoscale={"min_replicas": 2, "max_replicas": 3, "stable_s": 0.1,
                   "cooldown_s": 0.3, "interval_s": 0.05})
    with cluster:
        prompts = [_prompt(5 + i % 2, 40 + i) for i in range(4)]
        hs = [cluster.submit(p, max_new_tokens=20, tier="standard")
              for p in prompts]
        victim = cluster.pool.engines[0].replica
        faults.inject(f"cluster.replica_preempt@{victim}", times=1)
        try:
            res = [h.result(timeout=300) for h in hs]
        finally:
            faults.clear()
        assert res == [jref(p, 20) for p in prompts]
        t0 = time.time()
        while True:
            ids = [e.replica for e in cluster.pool.engines]
            if victim not in ids and len(ids) >= 2:
                break
            assert time.time() - t0 < 60, f"victim never replaced: {ids}"
            time.sleep(0.01)
        assert "pcl-reap/2" in ids
        events = [r["event"] for r in cluster.autoscaler.timeline()]
        assert "reap" in events and "up" in events
    assert metrics.counter("cluster.scale_events").get(
        cluster="pcl-reap", direction="reap") == 1


def test_added_replica_joins_only_once_started(model):
    """A replica added to a started pool joins it only once started: an
    autoscaler tick between its build and its start sees no "stopped"
    replica to reap (a reaped one would be started after the reap and
    never stopped), and the cluster's stop() stops it."""
    cluster = _cluster(
        "torch", model, "pcl-join",
        autoscale={"min_replicas": 2, "max_replicas": 3, "stable_s": 1e9,
                   "interval_s": 0.05})
    with cluster:
        pool = cluster.pool
        build = pool._build_engine
        ticks = []

        def build_then_tick_before_start(i):
            e = build(i)
            start = e.start

            def start_after_a_tick():
                ticks.append(cluster.autoscaler.tick(
                    now=time.monotonic() + 1e6))
                return start()

            e.start = start_after_a_tick
            return e

        pool._build_engine = build_then_tick_before_start
        e = pool.add_replica()
        assert ticks == [None]
        assert e in pool.engines and e._started
        assert [r["event"] for r in cluster.autoscaler.timeline()] == []
    assert not e._started


def test_serve_gpt_cluster_example_runs(capsys):
    """The ported example on the CPU: affinity routing, and the failover
    request byte-identical to its uninterrupted run."""
    from paddle_tpu_torch.examples import serve_gpt_cluster

    serve_gpt_cluster.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "byte-identical after failover" in out
    assert "affinity hit rate" in out


def test_launch_counters_exact_under_concurrent_threads():
    """Replicas launch and capture on threads of their own: the kernel
    counters move under one lock, and a capturing thread records its
    launches as its graph's own (added back per replay) without touching
    the counters.  Many threads, a short switch interval: no update is
    lost and no capture leaks into the counters."""
    import sys
    import threading

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    saved = (fa.LAUNCHES, dict(fa.FWD_BODY_LAUNCHES))
    fa.LAUNCHES = 0
    fa.FWD_BODY_LAUNCHES.update(dict.fromkeys(fa.FWD_BODY_LAUNCHES, 0))
    g = vars(fa)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    deltas = []

    def launcher():
        for _ in range(2000):
            _build.count_launch(g, "LAUNCHES")
            _build.count_launch(g, "FWD_BODY_LAUNCHES", "tc16")

    def capturer():
        with _build.recording_launches() as rec:
            for _ in range(500):
                _build.count_launch(g, "LAUNCHES")
        deltas.append(rec)
        for _ in range(3):                       # three replays
            _build.add_launches(rec)

    try:
        threads = [threading.Thread(target=launcher) for _ in range(12)] \
            + [threading.Thread(target=capturer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert deltas == [{(fa, "LAUNCHES"): 500}] * 4
        assert fa.LAUNCHES == 12 * 2000 + 4 * 3 * 500
        assert fa.FWD_BODY_LAUNCHES["tc16"] == 12 * 2000
    finally:
        sys.setswitchinterval(interval)
        fa.LAUNCHES = saved[0]
        fa.FWD_BODY_LAUNCHES.update(saved[1])


def test_capture_gc_hold_nests_across_threads():
    """The collector stays off while any thread captures: one capture's
    end does not turn it back on under another's."""
    import gc

    from paddle_tpu_torch.jit import graphs

    was = gc.isenabled()
    gc.enable()
    try:
        graphs._hold_gc()
        graphs._hold_gc()           # a second thread's capture begins
        graphs._release_gc()        # the first one ends
        assert not gc.isenabled()
        graphs._release_gc()
        assert gc.isenabled()
    finally:
        if not was:
            gc.disable()


def test_engine_cluster_hooks_match_jax(model, jax_model):
    """What the router and the autoscaler read off an engine —
    ``health_state`` through start, ``begin_drain`` and stop, ``quiescent``,
    the ``draining`` shed — equal the JAX engine's."""
    from paddle_tpu.serving import RequestRejectedError as JRejected

    seen = {}
    for side, mdl in (("torch", model), ("jax", jax_model)):
        kw = dict(num_slots=2, page_size=PS, max_model_len=MAXLEN,
                  replica=f"pcl-hooks-{side}")
        eng = ServingEngine(mdl, device="cpu", **kw) if side == "torch" \
            else JServingEngine(mdl, **kw)
        rows = [eng.health_state(), eng.quiescent]
        eng.start()
        eng.generate(_prompt(5, 70), max_new_tokens=3, timeout=300)
        rows += [eng.health_state(), eng.quiescent]
        eng.begin_drain()
        rows += [eng.health_state(), eng.quiescent]
        with pytest.raises((RequestRejectedError, JRejected)) as ei:
            eng.submit(_prompt(5, 71), max_new_tokens=2)
        rows.append(ei.value.reason)
        eng.stop()
        rows += [eng.health_state(), eng.quiescent]
        seen[side] = rows
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][4]["state"] == "draining"


def test_cluster_families_of_the_readme_table(model):
    """Every ``cluster.*`` family of the README's metrics table is in the
    port's registry once a cluster with an autoscaler is built."""
    import os
    import re

    readme = open(os.path.join(os.path.dirname(__file__), "..",
                               "README.md")).read()
    want = set(re.findall(r"^\| `(cluster\.[a-z_]+)` \|", readme, re.M))
    assert len(want) == 9
    _cluster("torch", model, "pcl-fam", autoscale={"min_replicas": 2})
    have = {m.name for m in metrics.get_registry().metrics()}
    assert want <= have, sorted(want - have)


def test_cluster_slo_accounting_on_outer_handles(model):
    """``slo=`` accounts the cluster's outer handles (failover gaps
    included) under ``cluster=<name>``, and every replica its own legs;
    the ``/statusz`` section carries the summary."""
    from paddle_tpu_torch.observability import slo

    pol = slo.SLOPolicy(ttft_s=120.0, itl_s=60.0, objective=0.9)
    cluster = _cluster("torch", model, "pcl-slo", slo=pol)
    with cluster:
        hs = [cluster.submit(_prompt(6, 80 + i), max_new_tokens=4)
              for i in range(3)]
        for h in hs:
            h.result(timeout=300)
        sz = cluster._statusz()
    assert sz["slo"]["window"]["attainment"] == 1.0
    reps = [pol.evaluate(slo.timeline_of(h)) for h in hs]
    rows = [(h.submitted_at, h.finished_at, r.tokens, r.good_tokens, r.met)
            for h, r in zip(hs, reps)]
    want = slo.SLOAccountant.window_rates(rows, pol.objective)
    reg = metrics.get_registry()
    assert reg.get("serving.slo.attainment").get(cluster="pcl-slo") \
        == want["attainment"] == 1.0
    assert cluster.engines[0].slo_accountant is not None
