"""PyTorch port, the program layer on the CPU against the JAX package: the
program ledger's keys (``encode_key`` JSON), families, kinds and cold /
warm flags after the same traffic through both engines (native, int8
pools, speculative k=2, chunked prefill, numeric guard, radix prefix
reuse) and through ``generate()``; the ``serving.*_traces`` mint counters
and ``program_traces()``, cold and after ``warmup()``; a manifest saved
by either package warming the other's engine; ``warmup()``'s refusals;
the second engine over one model; a restart that mints nothing; greedy
ids byte-identical to JAX's (float32, exact); the ported warm-restart
example.  Tiny GPT (4 layers, hidden 128), a few requests, a ``replica=``
of its own per engine (the JAX registry is process-wide); the JAX ledger
and roofline table are reset at setup, as
tests/test_program_observability.py resets them.  Every comparison here
is exact."""

import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import perf as jperf
from paddle_tpu.observability import programs as jprograms
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models._decode import program_store as jprogram_store
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import faults, perf, programs
from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from paddle_tpu_torch.text.models._decode import program_store
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

CFG = dict(vocab_size=96, hidden_size=128, num_hidden_layers=4,
           num_attention_heads=4, max_position_embeddings=64)
PS = 8
MAXLEN = 64
TRACES = ("serving.step_traces", "serving.prefill_traces",
          "serving.prefill_chunk_traces", "serving.verify_traces")


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


def _motif(n, seed):
    """A repeating motif: the n-gram drafter finds drafts in it."""
    m = _prompt(5, seed)
    return (m * (n // 5 + 1))[:n]


# prompt lengths cross the page (8) and power-of-two bucket edges
REQS = [(_prompt(3, 1), 6), (_prompt(13, 2), 5), (_motif(30, 3), 6),
        (_prompt(17, 4), 4)]


def _jax_gpt(seed=0):
    """Tiny GPT, trained 3 steps so greedy decode emits varied tokens."""
    paddle.seed(seed)
    m = JGPT(**CFG)
    o = jopt.AdamW(learning_rate=1e-2, parameters=m.parameters())
    step = paddle.jit.TrainStep(m, o, loss_fn=None)
    ids = paddle.to_tensor(
        np.random.RandomState(0).randint(1, 96, (4, 16)).astype("int64"))
    for _ in range(3):
        step({"input_ids": ids, "labels": ids})
    return m.eval()


def _port_of(jm):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(
        m, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return m.eval()


@pytest.fixture(scope="module")
def pair():
    jprograms.ledger().reset()
    jperf.reset()
    programs.ledger().reset()
    perf.reset()
    jm = _jax_gpt()
    return jm, _port_of(jm)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()


def _engine(name, model, replica, **kw):
    kw.setdefault("num_slots", 4)
    if name == "jax":
        return JServingEngine(model, page_size=PS, max_model_len=MAXLEN,
                              replica=replica, **kw)
    return ServingEngine(model, device="cpu", page_size=PS,
                         max_model_len=MAXLEN, replica=replica, **kw)


def _held(name, eng, reqs):
    """Submit while the scheduler sits in a wedge, so one admission pass
    sees every request (the co-scheduling, and so the programs a run
    needs, is then the same in both packages)."""
    import time

    f = jfaults if name == "jax" else faults
    site = f"serving.scheduler_wedge@{eng.replica}"
    f.inject(site, seconds=30.0, times=1)
    t0 = time.monotonic()
    while f.trip_count(site) < 1:
        assert time.monotonic() - t0 < 60
        time.sleep(0.005)
    hs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    f.clear(site)
    return hs


def _serve(name, eng, reqs):
    with eng:
        return [h.result(timeout=300) for h in _held(name, eng, reqs)]


def _ledger_rows(name, model):
    """(key JSON, family, kind, cold/warm) of every ledger row of
    ``model``'s program store."""
    led = (jprograms if name == "jax" else programs).ledger()
    store = (jprogram_store if name == "jax" else program_store)(model)
    enc = (jprograms if name == "jax" else programs).encode_key
    with led._lock:
        ents = [e for e in led._entries.values() if e._sid == id(store)]
    return sorted((json.dumps(enc(e.key)), e.family, e.kind,
                   "warm" if e.warm else "cold") for e in ents)


def _traces(name, replica):
    reg = (jmetrics if name == "jax" else metrics).get_registry()
    return {f: reg.get(f).get(replica=replica) or 0 for f in TRACES}


CASES = {
    "native": ({}, REQS),
    "int8": ({"kv_dtype": "int8"}, REQS),
    "spec": ({"speculative_k": 2}, [(_motif(12, 5), 8), (_motif(20, 6), 8)]),
    "chunk": ({"prefill_chunk_tokens": 8}, REQS),
    "guard": ({"numeric_guard": True}, REQS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_and_mints_equal_jax(pair, case):
    """The same held traffic through both engines: equal ids, equal
    ledger rows (keys, families, kinds, cold flags), equal mint counters
    per kind and equal ``program_traces()``."""
    jm, tm = pair
    kw, reqs = CASES[case]
    out = {}
    for name, m in (("jax", jm), ("torch", tm)):
        eng = _engine(name, m, f"{name[0]}-prog-{case}", **kw)
        ids = _serve(name, eng, reqs)
        out[name] = (ids, _ledger_rows(name, m), _traces(name, eng.replica),
                     eng.program_traces(), eng.step_traces)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    assert out["torch"][3:] == out["jax"][3:]
    assert sum(out["torch"][2].values()) > 0 or case != "native"


def test_radix_cached_tail_keys_equal_jax(pair):
    """Radix reuse: the cached tail runs the chunk program at its prefill
    bucket (``serve_prefill_chunk/<b>``, counted as a prefill mint, as the
    reference counts it), the same keys and counts as JAX's."""
    jm, tm = pair
    base = _prompt(24, 9)
    wave1 = [(base + _prompt(3, 10), 4)]
    wave2 = [(base + _prompt(5, 11), 4), (base + _prompt(9, 12), 4)]
    out = {}
    for name, m in (("jax", jm), ("torch", tm)):
        eng = _engine(name, m, f"{name[0]}-prog-radix", prefix_cache="radix")
        with eng:
            a = [h.result(timeout=300) for h in _held(name, eng, wave1)]
            b = [h.result(timeout=300) for h in _held(name, eng, wave2)]
            cached = eng.stats()["cached_prefills"] if name == "torch" \
                else None
        out[name] = (a + b, _ledger_rows(name, m),
                     _traces(name, eng.replica))
    assert out["torch"] == out["jax"]
    assert cached == 2
    assert any(r[0].startswith('["serve_prefill_chunk", 8,')
               for r in out["torch"][1])


def test_second_engine_over_one_model_mints_nothing(pair):
    """A second engine over the same model finds every key minted: its
    step_traces reads 1 (tests/test_serving.py's invariant), its counters
    stay 0 — on the card it captures its own graphs, uncounted."""
    jm, tm = pair
    for name, m in (("jax", jm), ("torch", tm)):
        _serve(name, _engine(name, m, f"{name[0]}-prog-first"), REQS[:2])
        eng = _engine(name, m, f"{name[0]}-prog-second")
        n0 = eng.program_traces()
        _serve(name, eng, REQS[:2])
        assert eng.step_traces == 1, name
        assert eng.program_traces() == n0, name
        assert sum(_traces(name, eng.replica).values()) == 0, name


def _fresh(jm):
    """Same weights, fresh program stores (a restarted process)."""
    jm2 = _jax_gpt()
    return jm2, _port_of(jm2)


@pytest.fixture(scope="module")
def fresh_pair(pair):
    return _fresh(pair[0])


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_manifest_warms_either_engine(pair, src, tmp_path):
    """A cold engine's manifest (saved by ``src``) warms a fresh engine of
    EACH package before start(): every key replays, the first requests
    mint nothing, pay no stall and give the cold ids."""
    jm, tm = pair
    cold = {}
    for name, m in (("jax", jm), ("torch", tm)):
        eng = _engine(name, m, f"{name[0]}-prog-cold-{src}")
        cold[name] = (_serve(name, eng, REQS), eng)
    path = cold[src][1].capture_manifest().save(tmp_path / "man.json")
    man = json.load(open(path))
    assert man["schema"] == "paddle_tpu/warmup-manifest/v1"
    assert man["meta"]["adapter"]["dtype"] == "float32"
    jf, tf = _fresh(jm)
    warmed = {}
    for name, m in (("jax", jf), ("torch", tf)):
        eng = _engine(name, m, f"{name[0]}-prog-warm-{src}")
        info = eng.warmup(str(path))
        # the store holds earlier cases' keys too (int8, guard, ...): the
        # ones of this engine's configuration replay, the others skip
        assert info["warmed"] >= 3
        assert info["warmed"] + info["skipped"] == len(man["keys"])
        warmed[name] = info["warmed"]
        n0 = eng.program_traces()
        with eng:
            hs = _held(name, eng, REQS)
            ids = [h.result(timeout=300) for h in hs]
        assert eng.program_traces() == n0, name
        assert all(h.compile_s == 0.0 for h in hs), name
        assert ids == cold[name][0] == cold["jax"][0], name
    assert warmed["torch"] == warmed["jax"]


def test_warmup_refusals(pair):
    """warmup() after start() raises RuntimeError, a manifest stamped for
    another adapter geometry raises ValueError — in both packages."""
    jm, tm = pair
    for name, m in (("jax", jm), ("torch", tm)):
        eng = _engine(name, m, f"{name[0]}-prog-refuse")
        man = eng.capture_manifest()
        man.meta["adapter"] = dict(man.meta["adapter"], page_size=PS * 2)
        with pytest.raises(ValueError, match="manifest captured for"):
            eng.warmup(man)
        with eng:
            with pytest.raises(RuntimeError, match="before start"):
                eng.warmup(eng.capture_manifest())


def test_restart_mints_nothing(pair):
    """A transient step crash at the 3rd decode step restarts the engine:
    the requeued requests finish with the ids of an uninterrupted run, and
    the only mints are the requeued prompts' new prefill buckets, as in
    the reference (its keys are shapes: nothing is re-minted)."""
    from paddle_tpu.resilience import TransientError as JTransientError
    from paddle_tpu_torch.resilience import TransientError

    jm, tm = pair
    out = {}
    for name, m, err in (("jax", jm, JTransientError),
                         ("torch", tm, TransientError)):
        want = _serve(name, _engine(name, m, f"{name[0]}-prog-plain"), REQS)
        eng = _engine(name, m, f"{name[0]}-prog-restart")
        before = _ledger_rows(name, m)
        n0 = eng.program_traces()

        def boom(err=err):
            raise err("injected decode crash")

        (jfaults if name == "jax" else faults).inject(
            f"serving.step_crash@{eng.replica}", fn=boom, at_trips={3})
        got = _serve(name, eng, REQS)
        assert got == want, name
        new = sorted(set(_ledger_rows(name, m)) - set(before))
        out[name] = (got, eng.program_traces() - n0, new,
                     _traces(name, eng.replica))
    assert out["torch"] == out["jax"]
    assert not any(r[0].startswith('["serve_step"') for r in out["torch"][2])
    assert out["torch"][3]["serving.step_traces"] == 0


@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_generate_rows_equal_jax(fresh_pair, impl):
    """generate(): the same greedy ids and one ``generate.decode`` ledger
    row per program key, cold at the first call and warm after; warm calls
    land in the perf table per emitted token."""
    jm, tm = fresh_pair
    ids = np.random.RandomState(3).randint(1, 96, (2, 9))
    outs = {}
    for name, m in (("jax", jm), ("torch", tm)):
        a = m.generate(paddle.to_tensor(ids) if name == "jax" else ids,
                       max_new_tokens=6, temperature=0.0, cache_impl=impl)
        b = m.generate(paddle.to_tensor(ids) if name == "jax" else ids,
                       max_new_tokens=6, temperature=0.0, cache_impl=impl)
        outs[name] = (np.asarray(a.numpy()), np.asarray(b.numpy()),
                      [r for r in _ledger_rows(name, m)
                       if r[1] == "generate.decode"])
    np.testing.assert_array_equal(outs["torch"][0], outs["jax"][0])
    np.testing.assert_array_equal(outs["torch"][1], outs["jax"][0])
    assert outs["torch"][2] == outs["jax"][2]
    assert any(f'"{impl}"' in r[0] for r in outs["torch"][2])
    row = {r["program"]: r for r in perf.snapshot()}["generate.decode"]
    assert row["calls"] >= 6


def test_generate_frees_its_cache_and_step(pair, monkeypatch):
    """generate() keeps its program keys in the model's store and nothing
    else: every call's cache (and its step program) dies with the call,
    over several prompt lengths, dense and paged."""
    import gc
    import weakref

    import torch

    from paddle_tpu_torch.text.models import _decode

    _, tm = pair
    made = []
    real = _decode.decode_loop

    def spy(model, fwd, ids0, n, init_cache, **kw):
        def init():
            cache = init_cache()
            made.extend(weakref.ref(t) for t in cache)
            return cache
        return real(model, fwd, ids0, n, init, **kw)

    monkeypatch.setattr(_decode, "decode_loop", spy)
    keys = set()
    for impl in ("dense", "paged"):
        for s0 in (5, 9, 14):
            ids = np.random.RandomState(s0).randint(1, 96, (2, s0))
            tm.generate(ids, max_new_tokens=4, temperature=0.0,
                        cache_impl=impl)
            keys.add((impl, 2, s0))
    gc.collect()
    assert len(made) == 12 and all(r() is None for r in made)
    ents = {k[:3]: v for k, v in program_store(tm).items()
            if k[0] in ("dense", "paged")}
    assert keys <= set(ents)
    assert not [v for e in ents.values() for v in vars(e).values()
                if isinstance(v, torch.Tensor)]


def test_resolving_costs_leaves_the_engine_as_it_was(pair):
    """The perf table's cost count runs a program over the engine's live
    pools, which it reads and never writes or copies, and draws nothing
    from the engine's generator: the pools are byte-equal across the
    count, and an engine whose costs were resolved between two sampled
    requests gives the ids of one whose were not."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tm = pair
    reqs = [(_prompt(9, 7), 5), (_prompt(5, 8), 5)]
    outs = {}
    for tag in ("count", "plain"):
        perf.reset()
        eng = _engine("torch", tm, f"cost-{tag}")
        with eng:
            first = eng.submit(reqs[0][0], max_new_tokens=reqs[0][1],
                               temperature=0.8).result(timeout=300)
            if tag == "count":
                pools = [p.clone() for p in eng._pools]
                held = {p.untyped_storage().data_ptr() for p in eng._pools}
                copied = []

                class Spy(TorchDispatchMode):
                    def __torch_dispatch__(self, func, types, args=(),
                                           kwargs=None):
                        if func._overloadpacket in (
                                torch.ops.aten.clone, torch.ops.aten._to_copy) \
                                and args[0].untyped_storage().data_ptr() \
                                in held:
                            copied.append(func)
                        return func(*args, **(kwargs or {}))

                with Spy():
                    rows = {r["program"]: r
                            for r in perf.snapshot(resolve=True)}
                assert rows["decode"]["flops_per_call"] > 0
                assert not copied
                assert all(torch.equal(a, b)
                           for a, b in zip(pools, eng._pools))
            second = eng.submit(reqs[1][0], max_new_tokens=reqs[1][1],
                                temperature=0.8).result(timeout=300)
        outs[tag] = (first, second)
    assert outs["count"] == outs["plain"]


def test_ported_example_runs_on_the_cpu(tmp_path):
    from paddle_tpu_torch.examples import serve_gpt_warm

    out = serve_gpt_warm.main(device="cpu",
                              manifest_path=str(tmp_path / "m.json"))
    assert out["warm_traces"] == 0 and out["warm"]["compile_s"] == 0.0
    assert out["warm_ids"] == out["cold_ids"]
    assert out["warmup"]["warmed"] >= 2
