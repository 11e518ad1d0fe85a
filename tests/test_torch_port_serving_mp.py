"""PyTorch port, the serving mesh: ``ServingEngine(mesh=[...])`` with one
process per shard, ``ReplicaPool(mp=)`` / ``ServingCluster(mp=)`` and
``generate()`` under fleet mp, on the CPU (``mesh=["cpu", "cpu"]``: a
leader and one follower process over a private gloo group).

Mirrors ``tests/test_serving_mp.py``, whose sharded cases the reference
runs only in its slow tier (each needs a subprocess with forced host
devices): greedy ids at mp = 2 equal the port's mp = 1 engine's and the
JAX package's mp = 1 engine's on the same converted weights, byte for
byte, for the plain, int8-KV, int8-weight, chunked-prefill and
speculative engines, through a ``serving.step_crash`` restart, and for
dp 2 x mp 2 behind the router; ``bytes_per_page`` halves and the same
budget holds twice the sequences; one decode-step mint over a mixed
workload; the ledger's ``shard`` rows; the carve errors; a killed follower
fails the engine and no child outlives ``close()``.

Every JAX engine runs on a replica of its own (the JAX metrics registry is
process-wide); torch runs one intra-op thread (so do the followers)."""

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import faults
from paddle_tpu_torch.serving import ServingCluster, ServingEngine
from paddle_tpu_torch.serving.cluster import ReplicaPool
from paddle_tpu_torch.serving.mesh import MeshError
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_dist_workers import RankPool
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8
MAXLEN = 64
NEW = 12
MESH = ["cpu", "cpu"]


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


# mixed lengths, crossing page boundaries (the reference test's)
PROMPTS = [_prompt(3, 2), _prompt(8, 3), _prompt(13, 4), _prompt(16, 5)]
KINDS = {"plain": {}, "int8": {"kv_dtype": "int8"},
         "int8w": {"kv_dtype": "int8", "weight_dtype": "int8"},
         "chunked": {"prefill_chunk_tokens": 8},
         "spec": {"speculative_k": 2}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_jax_gpt():
    """The reference test's tiny GPT, trained 5 steps so greedy decode
    emits varied tokens."""
    paddle.seed(0)
    m = JGPT(**CFG)
    o = jopt.AdamW(learning_rate=1e-2, parameters=m.parameters())
    step = paddle.jit.TrainStep(m, o, loss_fn=None)
    ids = paddle.to_tensor(
        np.random.RandomState(0).randint(1, 96, (8, 20)).astype("int64"))
    for _ in range(5):
        step({"input_ids": ids, "labels": ids})
    return m.eval()


@pytest.fixture(scope="module")
def jax_model():
    return tiny_jax_gpt()


@pytest.fixture(scope="module")
def state(jax_model):
    return {k: np.asarray(v._value)
            for k, v in jax_model.state_dict().items()}


def port_model(state):
    """A fresh port GPT (its own program store) on the converted
    weights."""
    m = GPTForCausalLM(device="cpu", **CFG).eval()
    load_paddle_tpu_state_dict(m, state)
    return m


def _engine(model, **kw):
    return ServingEngine(model, num_slots=3, page_size=PS,
                         max_model_len=MAXLEN, **kw)


def _serve(eng, prompts=PROMPTS):
    with eng:
        hs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        return [h.result(timeout=120) for h in hs], eng.stats()


def _children():
    return {p.pid for p in multiprocessing.active_children()}


# ------------------------------------------------------------ greedy parity
@pytest.fixture(scope="module")
def parity(state, jax_model):
    """Every engine kind at mp = 2 (their followers start side by side),
    the port's mp = 1 twin, and the JAX package's mp = 1 engine."""
    before = _children()
    mesh = {k: _engine(port_model(state), mesh=MESH, **kw)
            for k, kw in KINDS.items()}
    out = {}
    for i, (kind, kw) in enumerate(KINDS.items()):
        # weight_dtype="int8" converts a JAX model in place: its own copy
        jm = tiny_jax_gpt() if kind == "int8w" else jax_model
        with JServingEngine(jm, num_slots=3, page_size=PS,
                            max_model_len=MAXLEN, replica=f"jmp-{i}",
                            **kw) as je:
            jax_ids = [h.result(timeout=300) for h in
                       [je.submit(p, max_new_tokens=NEW) for p in PROMPTS]]
        ids1, st1 = _serve(_engine(port_model(state), device="cpu", **kw))
        eng = mesh[kind]
        ids2, st2 = _serve(eng)
        cap = None
        if kind == "plain":
            with _engine(port_model(state), device="cpu") as e1:
                bm1 = e1.block_manager
                bm2 = eng.block_manager
                budget = 64 * bm1.bytes_per_page
                cap = (bm1.shards, bm2.shards,
                       bm1.max_resident_sequences(MAXLEN,
                                                  budget_bytes=budget),
                       bm2.max_resident_sequences(MAXLEN,
                                                  budget_bytes=budget))
        out[kind] = dict(jax=jax_ids, mp1=ids1, mp2=ids2, st1=st1, st2=st2,
                         cap=cap, pid=[p.pid for p in eng._mesh.procs])
        eng.close()
    out["left"] = _children() - before
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_mp2_greedy_ids_equal_mp1_and_reference(parity, kind):
    r = parity[kind]
    assert r["mp1"] == r["jax"], kind
    assert r["mp2"] == r["mp1"], kind
    assert len({tuple(o) for o in r["mp2"]}) > 1     # varied outputs
    assert r["st2"]["mp"] == 2 and r["st1"]["mp"] == 1
    assert r["st2"]["weight_dtype"] == r["st1"]["weight_dtype"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_mp2_bytes_per_page_is_one_shard(parity, kind):
    r = parity[kind]
    # payload AND scale pools split on heads: each card holds half a page
    assert r["st2"]["bytes_per_page"] * 2 == r["st1"]["bytes_per_page"]
    assert r["st2"]["kv_bytes_per_token"] * 2 \
        == r["st1"]["kv_bytes_per_token"]


def test_mp2_capacity_doubles_at_the_same_budget(parity):
    s1, s2, n1, n2 = parity["plain"]["cap"]
    assert (s1, s2) == (1, 2)
    assert n2 == 2 * n1 and n1 > 0


def test_no_follower_outlives_its_engine(parity):
    pids = [pid for r in (parity[k] for k in KINDS) for pid in r["pid"]]
    assert len(pids) == len(KINDS)
    assert not (set(pids) & parity["left"])
    assert not parity["left"]


# ----------------------------------------------------- programs and ledger
def test_mp2_one_decode_mint_and_own_key_space(state):
    """A mixed workload (varied lengths and budgets, greedy AND sampled
    rows) mints the decode step once; a second mp = 2 engine over the
    same model reuses the key; an mp = 1 engine keeps its own key space;
    the families carry ``@mp2``."""
    from paddle_tpu_torch.observability import perf as obs_perf

    m = port_model(state)
    a = _engine(m, mesh=MESH, replica="mpk-a")
    b = _engine(m, mesh=MESH, replica="mpk-b")
    with a:
        hs = [a.submit(_prompt(3 + 2 * i, 70 + i), max_new_tokens=4 + 3 * i,
                       temperature=0.0 if i % 2 == 0 else 0.8)
              for i in range(5)]
        for h in hs:
            h.result(timeout=120)
        assert a.step_traces == 1
        key = a._step_store_key()
        assert key[-2:] == ("mp", 2) and key[3][3] == CFG[
            "num_attention_heads"]
        assert a._device_label() == "mesh[2]:model"
    with b:
        b.generate(_prompt(4, 75), max_new_tokens=3, timeout=120)
        assert b.step_traces == 1 and b._step_store_key() == key
        assert b.stats()["step_traces"] == 1
    with _engine(m, device="cpu", replica="mpk-c") as c:
        c.generate(_prompt(4, 76), max_new_tokens=3, timeout=120)
        assert c.step_traces == 1
        assert c._step_store_key() != key
        assert c._step_store_key()[-2:] != ("mp", 2)
    fams = {r["program"] for r in obs_perf.snapshot()}
    assert any(f.startswith("decode@mp2") for f in fams), fams
    assert "decode" in fams, fams
    assert obs_perf.mp_degree("decode@mp2") == 2
    h = obs_perf.candidate_hint("decode@mp2", "bandwidth-bound")
    assert "sharded" in h and "int8" in h and "mesh=" not in h
    assert a._mesh.procs[0].exitcode is not None


def test_mp2_ledger_shard_rows_and_restart_on_every_rank(state, parity):
    """The pools' ledger rows carry ``shard="model:2"`` and the statusz
    ``kv_capacity`` shows it; a ``serving.step_crash`` restart resets the
    pools on every rank and the requeued requests finish byte-identical."""
    from paddle_tpu_torch.observability.memory import ledger
    from paddle_tpu_torch.resilience.retry import TransientError

    ref = parity["plain"]["mp1"]
    eng = _engine(port_model(state), mesh=MESH, replica="mpA")
    with eng:
        rows = [r for r in ledger().report()["owners"]
                if r.get("replica") == "mpA"
                and (r.get("meta") or {}).get("kind") == "kv"]
        assert rows and all(r["meta"].get("shard") == "model:2"
                            for r in rows)
        caps = [c for c in ledger().statusz()["kv_capacity"]
                if c["replica"] == "mpA"]
        assert caps and all(c.get("shard") == "model:2" for c in caps)
        mem = eng._statusz()["memory"]
        assert {dt: 2 * b for dt, b in
                mem["pool_shard_bytes_by_dtype"].items()} \
            == mem["pool_bytes_by_dtype"]
        eng.generate(_prompt(4, 72), max_new_tokens=2, timeout=120)

        def boom():
            raise TransientError("injected decode crash")

        faults.inject("serving.step_crash", fn=boom, at_trips={4})
        try:
            hs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
            out = [h.result(timeout=120) for h in hs]
        finally:
            faults.clear()
        assert eng.stats()["engine_restarts"] == 1
        assert out == ref
        # the follower's pools went back to zeros with the leader's
        rows = eng.mesh_stats()
        assert [r["rank"] for r in rows] == [0, 1]
        assert rows[1]["mesh"]["calls"] == rows[0]["mesh"]["calls"] > 0
        assert rows[1]["pool_bytes"] == rows[0]["pool_bytes"]


def test_mp2_spill_pages_join_every_shard(state):
    """The spill tier's page snapshot joins every shard's heads (the whole
    page, as the reference's), and a restore splits it back."""
    m = port_model(state)
    with _engine(m, device="cpu") as e1, \
            _engine(m, mesh=MESH, replica="mpS") as e2:
        for e in (e1, e2):
            e.generate(PROMPTS[2], max_new_tokens=4, timeout=120)
        page = 0
        a, b = e1._spill_snapshot(page), e2._spill_snapshot(page)
        assert [t.shape for t in a] == [t.shape for t in b]
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
        assert float(b[0].abs().sum()) > 0
        e2._spill_restore(5, b)
        for x, y in zip(b, e2._spill_snapshot(5)):
            assert torch.equal(x, y)


# ------------------------------------------------------------- the cluster
def test_dp2_mp2_cluster_and_submeshes_through_the_router(state, parity):
    ref = parity["plain"]["mp1"]
    m = port_model(state)
    before = _children()
    cluster = ServingCluster(m, replicas=2, devices=["cpu"] * 4, mp=2,
                             num_slots=3, page_size=PS, max_model_len=MAXLEN,
                             replica_prefix="dpmp/", name="dpmp")
    pool2 = ReplicaPool(m, devices=[["cpu", "cpu"], ["cpu", "cpu"]],
                        num_slots=3, page_size=PS, max_model_len=MAXLEN,
                        replica_prefix="subm/")
    with cluster:
        pool = cluster._pool
        assert len(pool) == 2 and [len(g) for g in pool.meshes] == [2, 2]
        assert all(e.stats()["mp"] == 2 for e in pool.engines)
        hs = [cluster.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        out = [h.result(timeout=120) for h in hs]
    assert out == ref
    with pool2:
        assert [e.stats()["mp"] for e in pool2.engines] == [2, 2]
        got = pool2.engines[1].generate(PROMPTS[0], max_new_tokens=NEW,
                                        timeout=120)
    assert got == ref[0]
    assert not (_children() - before)


# ---------------------------------------------------- host-side validation
def test_pool_carve_divisibility_error():
    with pytest.raises(ValueError, match="not divisible by mp=3"):
        ReplicaPool(object(), devices=["cpu"] * 4, mp=3, num_slots=1)


def test_pool_rejects_mixed_devices_and_submeshes():
    with pytest.raises(ValueError, match="mixes single devices"):
        ReplicaPool(object(), devices=["cpu", ["cpu"]], num_slots=1)


def test_pool_rejects_mp_with_explicit_submeshes():
    with pytest.raises(ValueError, match="EITHER mp=N"):
        ReplicaPool(object(), devices=[["cpu"]], mp=2, num_slots=1)


def test_mesh_argument_errors(state):
    import jax
    from jax.sharding import Mesh

    m = port_model(state)
    with pytest.raises(TypeError, match="jax.sharding.Mesh"):
        ServingEngine(m, mesh=Mesh(np.asarray(jax.devices()[:1]), ("model",)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(m, mesh=MESH, device="cpu")
    with pytest.raises(ValueError, match="num_kv_heads divisible"):
        ServingEngine(m, mesh=["cpu"] * 4, page_size=PS)
    # a 1-long mesh is plain placement: no follower, mp = 1 keys
    with ServingEngine(m, mesh=["cpu"], num_slots=1, page_size=PS,
                       max_model_len=MAXLEN) as e:
        assert e._mesh is None and e.stats()["mp"] == 1
        assert e._step_store_key()[-2:] != ("mp", 1)


# ------------------------------------------------------------------ faults
def test_killed_follower_fails_the_engine_and_close_reaps(state):
    eng = _engine(port_model(state), mesh=MESH, replica="mpK")
    with eng:
        eng.generate(PROMPTS[0], max_new_tokens=2, timeout=120)
        pid = eng._mesh.procs[0].pid
        os.kill(pid, signal.SIGKILL)
        eng._mesh.procs[0].join(30)
        t0 = time.monotonic()
        h = eng.submit(PROMPTS[1], max_new_tokens=4)
        with pytest.raises(RuntimeError) as err:
            h.result(timeout=60)
        assert isinstance(err.value.__cause__, MeshError)
        assert "follower 1 exited" in str(err.value.__cause__)
        assert time.monotonic() - t0 < 30
        assert eng.health == "error" and eng.stats()["engine_restarts"] == 0
    assert pid not in _children()
    with pytest.raises(RuntimeError):
        eng.start()


# ------------------------------------------------- generate() under fleet
@pytest.fixture(scope="module")
def ranks():
    p = RankPool(2)
    yield p
    p.close()


def test_generate_under_fleet_mp2_equals_unsharded(state, ranks):
    ids = np.random.RandomState(9).randint(1, 96, (2, 7)).astype("int64")
    res = ranks.run("gpt_generate_mp", state, ids, CFG, 10, PS)
    m = port_model(state)
    x = torch.from_numpy(ids)
    want = {"dense": m.generate(x, max_new_tokens=10, temperature=0.0),
            "paged": m.generate(x, max_new_tokens=10, temperature=0.0,
                                cache_impl="paged", page_size=PS),
            "no_cache": m.generate(x, max_new_tokens=10, temperature=0.0,
                                   use_cache=False),
            "beam": m.generate(x, max_new_tokens=10,
                               decode_strategy="beam_search", num_beams=2)}
    assert sorted(r["mp_rank"] for r in res) == [0, 1]
    assert [r["heads"] for r in res] == [1, 1]
    for k, v in want.items():
        for r in res:
            np.testing.assert_array_equal(r[k], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(res[0]["sampled"], res[1]["sampled"])
    assert len({tuple(row) for row in want["dense"][:, 7:].tolist()}) > 1
