"""PyTorch port, engine robustness: paddle_tpu_torch's resilience/retry,
observability/faults, the numeric guard and ServingEngine's restart /
shedding / health / watchdog paths, on the CPU against the JAX package
on the same converted tiny GPT (num_slots=2, page_size=8,
max_model_len=64; the tiny trained GPT of test_torch_port_serving.py).

- ``classify_failure`` over the reference's exception table,
  ``RetryPolicy`` delays, ``derive_seed``, the fault registry's trip
  patterns (``at_trips`` / ``every`` / seeded ``probability`` / ``times``,
  ``FaultPlan``) and the ``numerics.nan_inject`` site: equal to JAX's.
- A ``TransientError`` from ``serving.step_crash`` restarts the engine:
  greedy ids equal to the JAX engine's under the same injection, and the
  restart and requeue counts equal, for the plain engine, mid chunked
  prefill, mid speculative verify and with int8 pools.  Admission is held
  at a ``serving.scheduler_wedge`` while the requests are submitted, so
  both engines admit them in the same iteration and the crash lands on
  the same decode step.
- A fatal error aborts every request and the engine rejects submits; an
  exhausted restart budget aborts too.
- A wedged scheduler sheds ``deadline_unmeetable`` and ``queue_full``
  (the same counts as JAX), reads ``degraded``, and recovers; the
  watchdog fires once per wedge and re-arms.
- The numeric guard: the guarded sampler's flags and greedy tokens equal
  to JAX's; off and on, greedy ids byte-identical (and equal to JAX's); a
  NaN injected at a prefill, a decode lane or a middle chunk fails only
  that request, with the JAX engine's fault count."""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import numerics as jnumerics
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.resilience import retry as jretry
from paddle_tpu.serving import RequestRejectedError as JRejected
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import faults, numerics
from paddle_tpu_torch.resilience import retry
from paddle_tpu_torch.serving import (EngineStoppedError, RequestRejectedError,
                                      ServingEngine)
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

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


def _wait(cond, budget=60.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < budget, "condition never held"
        time.sleep(0.005)


class _Side:
    """One package's engine, fault registry and counters, so a scenario
    runs identically on both."""

    def __init__(self, name, mdl, replica):
        self.name = name
        self.mdl = mdl
        self.replica = replica
        self.faults = jfaults if name == "jax" else faults
        self.retry = jretry if name == "jax" else retry
        self.rejected = JRejected if name == "jax" else RequestRejectedError

    def engine(self, **kw):
        kw.setdefault("num_slots", 2)
        cls = JServingEngine if self.name == "jax" else ServingEngine
        if self.name == "torch":
            kw["device"] = "cpu"
        return cls(self.mdl, page_size=PS, max_model_len=MAXLEN,
                   replica=self.replica, **kw)

    def count(self, eng, what):
        """Restarts / requeues / numeric faults / shed reasons: the JAX
        engine's registry series for its replica, the port's stats()."""
        if self.name == "torch":
            st = eng.stats()
            if what.startswith("shed:"):
                return st["load_shed"].get(what[5:], 0)
            return st[what]
        if what.startswith("shed:"):
            return jmetrics.counter("serving.load_shed").get(
                replica=self.replica, reason=what[5:]) or 0
        name = {"engine_restarts": "serving.engine_restarts",
                "requests_requeued": "serving.requests_requeued",
                "numeric_faults": "serving.numeric_faults"}[what]
        return jmetrics.counter(name).get(replica=self.replica) or 0


def _sides(jax_model, model, tag):
    """The two sides, on replica names no other test uses (the JAX
    registry is process-wide)."""
    return (_Side("jax", jax_model, f"j-{tag}"),
            _Side("torch", model, f"t-{tag}"))


def _submit_held(side, eng, reqs, arm=None):
    """Submit ``reqs`` [(prompt, max_new)] while the scheduler sits in a
    ``serving.scheduler_wedge``, so one admission pass sees them all; arm
    ``arm()`` (a fault) before releasing it."""
    f = side.faults
    site = f"serving.scheduler_wedge@{side.replica}"
    f.inject(site, seconds=30.0, times=1)
    _wait(lambda: f.trip_count(site) >= 1)
    hs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    if arm is not None:
        arm()
    f.clear(site)
    return hs


# ----------------------------------------------------------- policy units
_EXC_TABLE = [
    ("TransientError", "x"), ("PreemptionError", "x"),
    ("CollectiveTimeoutError", "x"), ("NumericFault", "nan"),
    ("EngineStoppedError", "stopped"),
    (TimeoutError, "t"), (ConnectionError, "c"), (BrokenPipeError, "b"),
    (FloatingPointError, "f"), (ValueError, "a real bug"),
    (KeyError, "k"), (RuntimeError, "DEADLINE EXCEEDED on recv"),
    (RuntimeError, "slice preempted by the scheduler"),
    (RuntimeError, "UNAVAILABLE: socket closed"),
    (RuntimeError, "connection reset by peer"),
    (RuntimeError, "coordination service heartbeat lost"),
    (RuntimeError, "barrier timed out"), (RuntimeError, "peer down"),
    (RuntimeError, "CUDA error: an illegal memory access was encountered"),
    (RuntimeError, "injected device fault"), (OSError, "broken pipe"),
]


@pytest.mark.parametrize("cls,msg", _EXC_TABLE,
                         ids=[f"{c if isinstance(c, str) else c.__name__}-{i}"
                              for i, (c, _) in enumerate(_EXC_TABLE)])
def test_classify_failure_matches_jax(cls, msg):
    if isinstance(cls, str):
        j, t = getattr(jretry, cls)(msg), getattr(retry, cls)(msg)
    else:
        j = t = cls(msg)
    assert retry.classify_failure(t) == jretry.classify_failure(j)


@pytest.mark.parametrize("kw", [dict(), dict(seed=7),
                                dict(base_delay=0.5, max_delay=3.0, seed=3),
                                dict(jitter=0.0, base_delay=2.0),
                                dict(jitter=1.0, seed=11)])
def test_retry_policy_delays_match_jax(kw):
    if "seed" not in kw and kw.get("jitter", 0.5):
        kw = dict(kw, seed=0)
    a, b = retry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    assert [a.delay(i) for i in range(1, 12)] \
        == [b.delay(i) for i in range(1, 12)]
    with pytest.raises(ValueError):
        retry.RetryPolicy(jitter=1.5)


def test_derive_seed_matches_jax():
    for parts in [(), ("fault", "serving.step_crash"), (7, 0, "x"),
                  (1.5, None, ("a", 2))]:
        assert retry.derive_seed(*parts) == jretry.derive_seed(*parts)


@pytest.mark.parametrize("kw", [
    dict(at_trips={3, 5}), dict(every=4), dict(times=2),
    dict(probability=0.3), dict(probability=0.5, seed=9),
    dict(every=2, times=3), dict(at_trips={2, 9}, probability=0.6)],
    ids=["at_trips", "every", "times", "probability", "probability-seed",
         "every-times", "at_trips-probability"])
def test_fault_trip_patterns_match_jax(kw):
    """Each registry fires its callable on the same calls of the same
    site, and reports the same trip counts and description."""

    def run(f):
        fired = []
        f.inject("unit.site", fn=lambda: fired.append(calls[0]), **kw)
        calls = [0]
        trips = []
        for _ in range(12):
            calls[0] += 1
            f.maybe("unit.site")
            trips.append(f.trip_count("unit.site"))
        desc = f.describe()
        f.clear()
        return fired, trips, desc, f.armed("unit.site")

    assert run(faults) == run(jfaults)


def test_fault_plan_matches_jax():
    def run(f):
        hits = []
        plan = (f.FaultPlan(seed=5)
                .add("a.site", fn=lambda: hits.append("a"), probability=0.4)
                .add("b.site", fn=lambda: hits.append("b"), at_trips={2}))
        with plan:
            for _ in range(10):
                f.maybe("a.site")
                f.maybe("b.site")
        return hits, plan.describe(), plan.sites

    assert run(faults) == run(jfaults)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 0.9)])
def test_guarded_sampler_matches_jax(top_k, top_p):
    """make_guarded_batched_sampler: the same non-finite-row flags as JAX's,
    and JAX's tokens on every greedy row (finite or not); temperature rows
    draw from another generator, so only their flags are compared."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.text.models._decode import \
        make_guarded_batched_sampler as jguarded
    from paddle_tpu_torch.text.models._decode import \
        make_guarded_batched_sampler

    rs = np.random.RandomState(7)
    logits = rs.randn(8, 40).astype(np.float32)
    logits[1, 3] = np.nan
    logits[4, :] = np.inf
    logits[6, 5] = -np.inf
    temps = np.asarray([0, 0, 0.7, 0, 0, 1.0, 0, 0.5], np.float32)
    jtok, jbad = jguarded(top_k, top_p)(jnp.asarray(logits),
                                        jnp.asarray(temps),
                                        jax.random.key(0))
    tok, bad = make_guarded_batched_sampler(top_k, top_p)(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.Generator().manual_seed(0))
    assert bad.tolist() == np.asarray(jbad).tolist()
    assert bad.tolist() == [False, True, False, False, True, False, True,
                            False]
    greedy = temps <= 0
    assert tok.numpy()[greedy].tolist() == np.asarray(jtok)[greedy].tolist()


def test_nan_inject_site_matches_jax():
    def run(f, num):
        out = []
        f.inject("numerics.nan_inject", at_trips={2, 3}, times=2)
        for _ in range(5):
            out.append(bool(np.isnan(num.consume_nan_inject())))
        f.clear()
        f.inject("numerics.nan_inject", times=1)   # re-arm: fresh count
        out.append(bool(np.isnan(num.consume_nan_inject())))
        out.append(bool(np.isnan(num.consume_nan_inject())))
        f.clear()
        return out

    assert run(faults, numerics) == run(jfaults, jnumerics)
    assert not numerics.serving_guard_default()
    numerics.enable_tensor_checker(serving_guard=True)
    try:
        assert numerics.serving_guard_default()
    finally:
        numerics.disable_tensor_checker()


# ------------------------------------------------------ restart + requeue
def _crash_run(side, kw, reqs, at_trip, warm=(4, 72)):
    def boom():
        raise side.retry.TransientError("injected decode crash")

    eng = side.engine(**kw)
    with eng:
        eng.generate(_prompt(*warm), max_new_tokens=2, timeout=300)
        hs = _submit_held(side, eng, reqs, arm=lambda: side.faults.inject(
            "serving.step_crash", fn=boom, at_trips={at_trip}))
        toks = [h.result(timeout=300) for h in hs]
        side.faults.clear()
        out = (toks, [h.status for h in hs], eng._engine_restarts,
               side.count(eng, "requests_requeued"))
        if side.name == "torch":
            assert eng.stats()["engine_restarts"] == 1
            assert eng.block_manager.free_pages \
                == eng.block_manager.num_pages
    return out


@pytest.mark.parametrize("name,kw,reqs,at_trip", [
    ("plain", {}, [(_prompt(6, 70), 12), (_prompt(9, 71), 10)], 4),
    ("spec", {"speculative_k": 4},
     [([2, 3, 4] * 4, 12), (_prompt(9, 71), 10)], 3),
    ("int8", {"kv_dtype": "int8"},
     [(_prompt(6, 40), 12), (_prompt(9, 41), 12)], 4),
], ids=["plain", "mid-verify", "int8"])
def test_step_crash_restarts_with_jax_ids(jax_model, model, name, kw, reqs,
                                          at_trip):
    j, t = _sides(jax_model, model, f"crash-{name}")
    want = _crash_run(j, kw, reqs, at_trip)
    got = _crash_run(t, kw, reqs, at_trip)
    assert got == want
    toks, statuses, restarts, requeued = got
    assert statuses == ["completed"] * len(reqs)
    assert restarts == 1 and requeued == len(reqs)
    # the uninterrupted run of the same engine gives the same ids
    eng = t.engine(**kw)
    with eng:
        assert [eng.generate(p, max_new_tokens=n, timeout=300)
                for p, n in reqs] == toks


def test_step_crash_mid_chunked_prefill_matches_jax(jax_model, model):
    """The crash lands while one slot is MID chunked prefill: it requeues
    from token 0, the decoding slot with its tokens so far."""
    short_p, long_p = _prompt(5, 51), _prompt(40, 52)
    j, t = _sides(jax_model, model, "crash-chunk")

    def run(side):
        eng = side.engine(prefill_chunk_tokens=8)
        seen = {}

        def boom():
            seen["mid_prefill"] = any(
                s is not None and s.prefilled is not None
                for s in eng._slots)
            raise side.retry.TransientError("injected crash mid chunk")

        with eng:
            eng.generate(_prompt(4, 53), max_new_tokens=2, timeout=300)
            hs = eng.submit(short_p, max_new_tokens=40)
            it = hs.stream()            # keep alive: abandonment cancels
            next(it)
            hl = eng.submit(long_p, max_new_tokens=10)
            side.faults.inject("serving.step_crash", fn=boom, at_trips={2})
            toks = [hs.result(timeout=300), hl.result(timeout=300)]
            side.faults.clear()
            return (toks, eng._engine_restarts,
                    side.count(eng, "requests_requeued"), seen)

    want, got = run(j), run(t)
    assert got == want
    assert got[3] == {"mid_prefill": True}
    assert got[1] == 1 and got[2] == 2
    eng = t.engine()
    with eng:
        assert [eng.generate(short_p, max_new_tokens=40, timeout=300),
                eng.generate(long_p, max_new_tokens=10, timeout=300)] \
            == got[0]


@pytest.mark.parametrize("case", ["fatal", "budget"])
def test_fatal_error_and_exhausted_budget_abort(jax_model, model, case):
    """A fatal error aborts without a restart; a transient one past
    ``max_engine_restarts`` aborts after the budget.  Either way every
    handle fails and the dead engine rejects new work."""
    j, t = _sides(jax_model, model, f"abort-{case}")

    def run(side):
        if case == "fatal":
            def fn():
                raise ValueError("a real scheduler bug")
            kw, arm = {}, dict(at_trips={1})
        else:
            def fn():
                raise side.retry.TransientError("flaky step")
            kw, arm = {"max_engine_restarts": 1}, {}
        eng = side.engine(num_slots=1, **kw)
        with eng:
            eng.generate(_prompt(4, 73), max_new_tokens=2, timeout=300)
            side.faults.inject("serving.step_crash", fn=fn, **arm)
            h = eng.submit(_prompt(6, 74), max_new_tokens=8)
            with pytest.raises(RuntimeError, match="serving engine failed"):
                h.result(timeout=300)
            side.faults.clear()
            out = (h.status, eng._engine_restarts, eng.health,
                   side.count(eng, "engine_restarts"))
        with pytest.raises(RuntimeError):
            eng.submit(_prompt(4, 75), max_new_tokens=2)
        return out

    got, want = run(t), run(j)
    assert got == want
    status, restarts, health, total = got
    assert status == "error" and health == "error"
    assert restarts == total == (0 if case == "fatal" else 1)


def test_recovery_rebuilds_pools_and_requeues(model):
    """_recover drops the old pools before it builds new ones, rebuilds the
    BlockManager, and puts in-flight work back at the queue's front."""
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                        max_model_len=MAXLEN)
    old = eng._pools
    eng._recover(RuntimeError("chaos"))
    assert eng._pools is not old and len(eng._pools) == len(old)
    assert all(p.shape == o.shape and p.dtype == o.dtype
               for p, o in zip(eng._pools, old))
    assert all(not p.is_inference() for p in eng._pools)
    assert eng.stats()["engine_restarts"] == 1
    assert eng.health_state()["state"] == "stopped"


def test_failed_recovery_fails_every_handle(model):
    """Recovery itself dies (the pool rebuild raises, as it would on a
    card with a sticky CUDA error): both in-flight requests end in
    ``error`` with the rebuild's exception, and the engine rejects work."""
    t = _Side("torch", model, "t-recover-dies")
    eng = t.engine()

    def boom():
        raise retry.TransientError("injected decode crash")

    def no_pools(num_pages):
        raise RuntimeError("CUDA error: out of memory")

    with eng:
        eng.generate(_prompt(4, 76), max_new_tokens=2, timeout=300)
        eng._adapter.init_pools = no_pools
        hs = _submit_held(t, eng, [(_prompt(6, 77), 12), (_prompt(9, 78), 10)],
                          arm=lambda: faults.inject(
                              "serving.step_crash", fn=boom, at_trips={2}))
        for h in hs:
            with pytest.raises(RuntimeError, match="serving engine failed"):
                h.result(timeout=60)
        faults.clear()
        assert [h.status for h in hs] == ["error", "error"]
        assert all("out of memory" in repr(h._error) for h in hs)
        assert eng.health == "error" and eng.stats()["engine_restarts"] == 1
    with pytest.raises(RuntimeError):
        eng.submit(_prompt(4, 79), max_new_tokens=2)


def test_crash_after_the_step_frees_old_pools_before_rebuild(model):
    """A TransientError raised after the adapter's step, from the sampler
    (whose frame and its callers' hold the pools and logits): every old
    pool is gone when the rebuild starts, and the ids are those of an
    uninterrupted run."""
    import weakref

    reqs = [(_prompt(6, 70), 12), (_prompt(9, 71), 10)]
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                        max_model_len=MAXLEN)
    with eng:
        want = [eng.generate(p, max_new_tokens=n, timeout=300)
                for p, n in reqs]
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                        max_model_len=MAXLEN, replica="t-free-pools")
    orig_sample, orig_init = eng._sample, eng._adapter.init_pools
    armed, seen = {"n": None}, {}

    def sample(logits, temps):
        out = orig_sample(logits, temps)
        if armed["n"] is not None:
            armed["n"] -= 1
            if armed["n"] == 0:
                armed["n"] = None
                seen["old"] = [weakref.ref(p) for p in eng._pools]
                raise retry.TransientError("crash after the step")
        return out

    def init_pools(num_pages):
        seen["alive"] = [r() is not None for r in seen["old"]]
        return orig_init(num_pages)

    eng._sample = sample
    eng._adapter.init_pools = init_pools
    t = _Side("torch", model, "t-free-pools")
    with eng:
        hs = _submit_held(t, eng, reqs, arm=lambda: armed.update(n=4))
        got = [h.result(timeout=300) for h in hs]
        assert eng.stats()["engine_restarts"] == 1
    assert seen["alive"] == [False] * len(seen["old"])
    assert got == want


# --------------------------------------------------- shedding and health
def test_wedge_sheds_with_distinct_reasons_then_recovers(jax_model, model):
    j, t = _sides(jax_model, model, "wedge")

    def run(side):
        eng = side.engine(num_slots=1, max_queue=2, degraded_stall_s=0.2)
        with eng:
            eng.generate(_prompt(4, 60), max_new_tokens=2, timeout=300)
            assert eng.health == "healthy"
            side.faults.inject("serving.scheduler_wedge", seconds=30.0)
            try:
                _wait(lambda: time.monotonic() - eng._progress_t > 0.5)
                h1 = eng.submit(_prompt(6, 61), max_new_tokens=4)
                with pytest.raises(side.rejected) as ei:
                    eng.submit(_prompt(4, 64), max_new_tokens=2,
                               deadline_s=0.05)
                r1 = ei.value.reason
                h2 = eng.submit(_prompt(6, 62), max_new_tokens=4)
                with pytest.raises(side.rejected) as ei:
                    eng.submit(_prompt(6, 63), max_new_tokens=4)
                r2 = ei.value.reason
                hz = eng.health_state()
            finally:
                side.faults.clear()
            toks = [h1.result(timeout=300), h2.result(timeout=300)]
            _wait(lambda: eng.health == "healthy")
            return (r1, r2, hz["state"],
                    sorted(r.split(":")[0] for r in hz["reasons"]), toks,
                    side.count(eng, "shed:queue_full"),
                    side.count(eng, "shed:deadline_unmeetable"))

    got, want = run(t), run(j)
    assert got == want
    assert got[:4] == ("deadline_unmeetable", "queue_full", "degraded",
                       ["queue_pressure", "scheduler_stalled"])
    assert got[5:] == (1, 1)


def test_deadline_estimate_and_draining(model):
    """The queue-position estimate sheds a deadline the typical request
    cannot meet; a draining engine sheds ``draining``."""
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                        max_model_len=MAXLEN)
    eng._progress_t = time.monotonic()
    for _ in range(4):
        eng._queue.append(object())
    eng._ema_request_s = 1.0
    eng._check_deadline_meetable(5.0)              # (4/2 + 1) x 1 s = 3 s
    with pytest.raises(RequestRejectedError) as ei:
        eng._check_deadline_meetable(2.0)
    assert ei.value.reason == "deadline_unmeetable"
    eng._queue.clear()
    with eng:
        eng.begin_drain()
        with pytest.raises(RequestRejectedError) as ei:
            eng.submit(_prompt(4, 1), max_new_tokens=2)
        assert ei.value.reason == "draining"
        assert eng.health == "draining" and eng.quiescent
        st = eng.stats()
    assert st["load_shed"] == {"deadline_unmeetable": 1, "draining": 1}
    assert eng.health == "stopped"


def test_watchdog_fires_once_per_wedge_and_rearms(model):
    eng = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                        max_model_len=MAXLEN, watchdog_s=0.2)
    with eng:
        eng.generate(_prompt(4, 90), max_new_tokens=2, timeout=300)
        wd = eng.watchdog
        assert wd is not None and wd.fired == []
        for n in (1, 2):
            faults.inject("serving.scheduler_wedge", seconds=30.0, times=1)
            _wait(lambda: faults.trip_count("serving.scheduler_wedge") >= 1)
            h = eng.submit(_prompt(5, 90 + n), max_new_tokens=3)
            _wait(lambda: len(wd.fired) >= n)
            time.sleep(0.3)             # still wedged: no second fire
            assert len(wd.fired) == n
            faults.clear()
            assert len(h.result(timeout=300)) == 3
        assert wd.fired[0]["age_s"] > 0.2
        assert eng.stats()["watchdog_fires"] == 2
    assert wd._thread is None               # stopped with the engine


# ------------------------------------------------------------ numeric guard
def test_guard_on_and_off_byte_identical(jax_model, model):
    prompts = [_prompt(5, 11), _prompt(13, 12), _prompt(30, 13)]
    want = None
    j = JServingEngine(jax_model, num_slots=2, page_size=PS,
                       max_model_len=MAXLEN, numeric_guard=True,
                       replica="j-guard-parity")
    with j:
        want = [j.generate(p, max_new_tokens=10, timeout=300)
                for p in prompts]
    for kw in ({}, {"prefill_chunk_tokens": 8}, {"speculative_k": 3}):
        outs = []
        for guard in (False, True):
            eng = ServingEngine(model, device="cpu", num_slots=2,
                                page_size=PS, max_model_len=MAXLEN,
                                numeric_guard=guard, **kw)
            with eng:
                outs.append([eng.generate(p, max_new_tokens=10, timeout=300)
                             for p in prompts])
                assert eng.stats()["numeric_guard"] is guard
        assert outs[0] == outs[1] == want, kw


@pytest.mark.parametrize("where", ["prefill", "decode", "chunk"])
def test_nan_fails_only_that_request(jax_model, model, where):
    """A NaN injected at a prefill, into one decode lane, or into a middle
    chunk of a chunked prefill fails exactly that request (NumericFault,
    status error); the other request completes with the unguarded ids."""
    j, t = _sides(jax_model, model, f"nan-{where}")
    kw = {"prefill_chunk_tokens": 8} if where == "chunk" else {}
    p0, p1 = ([5, 6, 7, 8] if where != "chunk" else _prompt(30, 5)), \
        [12, 13, 14]

    def run(side):
        num = jnumerics if side.name == "jax" else numerics
        err = jretry.NumericFault if side.name == "jax" \
            else retry.NumericFault
        eng = side.engine(numeric_guard=True, **kw)
        with eng:
            eng.generate(_prompt(4, 3), max_new_tokens=2, timeout=300)
            num.set_nan_inject_row(0)
            if where == "decode":
                h0 = eng.submit([9, 10, 11], max_new_tokens=40)
                h1 = eng.submit(p1, max_new_tokens=40)
                it0, it1 = h0.stream(), h1.stream()
                next(it0)
                next(it1)
                side.faults.inject("numerics.nan_inject", times=1)
            elif where == "prefill":
                # the trip lands on the first guarded dispatch after the
                # wedge: h0's prefill
                h0, h1 = _submit_held(
                    side, eng, [(p0, 12), (p1, 12)],
                    arm=lambda: side.faults.inject("numerics.nan_inject",
                                                   times=1))
            else:
                # guarded dispatches after the wedge: h1's prefill, h0's
                # first chunk, h1's decode step, h0's SECOND chunk (of 4)
                h1, h0 = _submit_held(
                    side, eng, [(p1, 12), (p0, 12)],
                    arm=lambda: side.faults.inject("numerics.nan_inject",
                                                   at_trips={4}))
            with pytest.raises(err) as ei:
                h0.result(timeout=300)
            out1 = h1.result(timeout=300)
            return (h0.status, h1.status, ei.value.site, out1,
                    side.count(eng, "numeric_faults"))

    want, got = run(j), run(t)
    assert got == want
    assert got[:3] == ("error", "completed", "logits") and got[4] == 1
    eng = t.engine()
    with eng:
        assert eng.generate(p1, max_new_tokens=len(got[3]),
                            timeout=300) == got[3]


def test_engine_stopped_error_is_reexported():
    """The handle surfaces a stop as EngineStoppedError, a NaN row as
    NumericFault (not wrapped as an engine failure)."""
    from paddle_tpu_torch.serving.engine import RequestHandle

    for err in (EngineStoppedError("s"), retry.NumericFault("n")):
        h = RequestHandle(0, 1)
        h._error = err
        h._done.set()
        with pytest.raises(type(err)):
            h.result(timeout=1)
