"""PyTorch port, QoS tiers and SLO accounting: paddle_tpu_torch's
serving/qos (TierPolicy, QoSConfig, brownout, TieredQueue),
observability/slo and ServingEngine(qos=...) on the CPU against the JAX
package (the tiny trained GPT of test_torch_port_serving.py, converted;
page_size=8, max_model_len=64).

- Tier validation errors, the default three-tier config, the brownout
  ladder and the TieredQueue's pop order over one random script: equal
  to JAX's.
- SLOPolicy.evaluate on synthetic timelines, and the accountant's window
  rates, equal to JAX's.
- Tiered submits give the JAX engine's greedy ids; a realtime arrival
  preempts a batch request, and every request's ids equal an
  uninterrupted run's (and JAX's), for the plain, int8, chunked and
  speculative engines, with JAX's preemption count.
- An impossible realtime SLO browns out the batch and standard tiers
  (shed with reason ``brownout``) while realtime still flows; a tier's
  ``max_queue`` caps its backlog alone; per-tier deadline estimates."""

import time
import types

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.observability import slo as jslo
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving import RequestRejectedError as JRejected
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import qos as jqos
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.observability import slo
from paddle_tpu_torch.serving import RequestRejectedError, ServingEngine, qos
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


def _engine(side, mdl, **kw):
    """``side``'s engine.  JAX engines run on a replica name of their own:
    the JAX metrics registry is process-wide, and tests/test_qos.py reads
    replica "0"'s shed and preemption series."""
    kw.setdefault("num_slots", 2)
    kw.setdefault("replica", f"{side}-port-qos")
    if side == "jax":
        return JServingEngine(mdl, page_size=PS, max_model_len=MAXLEN, **kw)
    return ServingEngine(mdl, device="cpu", page_size=PS,
                         max_model_len=MAXLEN, **kw)


def _wait_slots(eng, n, budget=30.0):
    t0 = time.monotonic()
    while sum(1 for s in eng._slots if s is not None) < n:
        assert time.monotonic() - t0 < budget, "slots never filled"
        time.sleep(0.005)


def _req(tier):
    return types.SimpleNamespace(tier=tier)


# ========================================================== policy units
def _error(fn):
    try:
        fn()
    except Exception as e:          # the class differs by package
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    lambda m: m.TierPolicy("x", priority=0, weight=0),
    lambda m: m.TierPolicy("", priority=0),
    lambda m: m.TierPolicy("x", priority=0, max_queue=0),
    lambda m: m.QoSConfig(tiers=(m.TierPolicy("a", 1), m.TierPolicy("a", 0))),
    lambda m: m.QoSConfig(tiers=(m.TierPolicy("a", 1), m.TierPolicy("b", 1))),
    lambda m: m.QoSConfig(tiers=(m.TierPolicy("a", 1),), default_tier="nope"),
    lambda m: m.QoSConfig(tiers=()),
    lambda m: m.QoSConfig().resolve("premium"),
    lambda m: m.QoSConfig().tier("premium"),
], ids=["weight", "name", "max_queue", "duplicate", "priorities", "default",
        "empty", "resolve", "tier"])
def test_tier_validation_matches_jax(case):
    got, want = _error(lambda: case(qos)), _error(lambda: case(jqos))
    assert got is not None and got == want


def test_default_config_matches_jax():
    a, b = qos.QoSConfig(), jqos.QoSConfig()
    assert a.names == b.names == ("realtime", "standard", "batch")
    assert a.to_dict() == b.to_dict()
    assert a.protected.name == b.protected.name == "realtime"
    assert a.default_tier == b.default_tier == "standard"
    for burn in (None, 0.0, 1.0, 2.0, 3.9, 4.0, 5.0, 100.0):
        assert a.shed_tiers(burn) == b.shed_tiers(burn)
    assert [a.resolve(n) for n in (None, "batch")] \
        == [b.resolve(n) for n in (None, "batch")]


@pytest.mark.parametrize("burn,preempting", [
    (0.0, False), (1.99, False), (2.0, False), (2.5, False), (4.0, False),
    (7.9, False), (8.0, False), (50.0, False), (0.0, True), (3.0, True),
    (None, False)])
def test_brownout_ladder_matches_jax(burn, preempting):
    for tiers in (None, (qos.TierPolicy("a", 1),
                         qos.TierPolicy("b", 0, shed_burn_rate=1.0))):
        jtiers = None if tiers is None else tuple(
            jqos.TierPolicy(**{f: getattr(t, f) for f in
                               ("name", "priority", "shed_burn_rate")})
            for t in tiers)
        assert qos.brownout(qos.QoSConfig(tiers), burn, preempting) \
            == jqos.brownout(jqos.QoSConfig(jtiers), burn, preempting)


def test_tiered_queue_pop_order_matches_jax():
    """One random script of append / appendleft / popleft / pop_exact /
    peek on both queues: the same tiers out, the same depths."""
    rs = np.random.RandomState(0)
    names = ("realtime", "standard", "batch")
    qs = (qos.TieredQueue(qos.QoSConfig()),
          jqos.TieredQueue(jqos.QoSConfig()))
    trace = ([], [])
    for step in range(400):
        op = rs.randint(0, 5)
        tier = names[rs.randint(0, 3)]
        for q, tr in zip(qs, trace):
            if op <= 1:
                q.append(_req(tier))
            elif op == 2:
                q.appendleft(_req(tier))
            elif op == 3 and q:
                tr.append(q.popleft().tier)
            elif op == 4 and q:
                head = q[0]
                tr.append(q.pop_exact(head).tier)
            tr.append((len(q), bool(q), q.depths(),
                       q.depth_at_or_above(1)))
    assert trace[0] == trace[1]
    # saturated: one credit cycle is 8 realtime, 3 standard, 1 batch
    q = qos.TieredQueue(qos.QoSConfig())
    for _ in range(10):
        for t in names:
            q.append(_req(t))
    assert [q.popleft().tier for _ in range(12)] \
        == ["realtime"] * 8 + ["standard"] * 3 + ["batch"]
    with pytest.raises(ValueError, match="not at the head"):
        q.pop_exact(_req("batch"))
    with pytest.raises(IndexError):
        qos.TieredQueue(qos.QoSConfig())[0]


def test_slo_evaluate_and_window_match_jax():
    rs = np.random.RandomState(3)
    policies = [dict(ttft_s=0.2), dict(itl_s=0.05), dict(e2e_s=1.0),
                dict(ttft_s=0.1, itl_s=0.03, e2e_s=0.5, objective=0.9),
                dict()]
    rows = []
    for i in range(40):
        sub = float(i)
        ts = tuple(sub + np.cumsum(rs.exponential(0.04, rs.randint(0, 12)))
                   + rs.exponential(0.1))
        fin = (ts[-1] if ts else sub) + 0.01 if i % 3 else None
        rows.append((sub, ts, fin))
    for kw in policies:
        a, b = slo.SLOPolicy(**kw), jslo.SLOPolicy(**kw)
        assert a.to_dict() == b.to_dict()
        for sub, ts, fin in rows:
            ra = a.evaluate(slo.RequestTimeline(sub, ts, fin))
            rb = b.evaluate(jslo.RequestTimeline(sub, ts, fin))
            assert dataclass_dict(ra) == dataclass_dict(rb)
        acc_a = slo.SLOAccountant(a, replica="x")
        acc_b = jslo.SLOAccountant(b, replica="slo-unit")
        for k, (sub, ts, fin) in enumerate(rows):
            h = types.SimpleNamespace(submitted_at=sub, token_times=ts,
                                      finished_at=fin, compile_s=0.0)
            over = False if k % 7 == 0 else None
            assert dataclass_dict(acc_a.observe(h, met_override=over)) \
                == dataclass_dict(acc_b.observe(h, met_override=over))
        assert acc_a.current() == acc_b.current()
        sa, sb = acc_a.summary(), acc_b.summary()
        assert sa == sb


def dataclass_dict(r):
    import dataclasses

    return dataclasses.asdict(r)


# ====================================================== engine behaviour
def test_tiered_submit_ids_equal_jax(jax_model, model):
    prompts = [_prompt(5, 2), _prompt(8, 3), _prompt(6, 4), _prompt(4, 5)]
    tiers = ["realtime", "standard", "batch", None]
    outs = {}
    for side, mdl in (("jax", jax_model), ("torch", model)):
        with _engine(side, mdl, qos=True) as eng:
            hs = [eng.submit(p, max_new_tokens=10, tier=t)
                  for p, t in zip(prompts, tiers)]
            outs[side] = ([h.result(timeout=300) for h in hs],
                          [h.tier for h in hs], eng.health)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == ["realtime", "standard", "batch", "standard"]
    with _engine("torch", model) as eng:
        with pytest.raises(ValueError, match="QoS-enabled"):
            eng.submit(_prompt(4, 6), max_new_tokens=2, tier="realtime")
        st = eng.stats()
    assert "qos" not in st
    with pytest.raises(TypeError):
        _engine("torch", model, qos="yes")


def _preempt_run(side, mdl, extra, n_prompt):
    bp1, bp2, rp = _prompt(n_prompt, 6), _prompt(n_prompt, 7), _prompt(4, 8)
    with _engine(side, mdl, qos=True, replica=f"{side}-pre-{extra}",
                 **extra) as eng:
        b1 = eng.submit(bp1, max_new_tokens=30, tier="batch")
        b2 = eng.submit(bp2, max_new_tokens=30, tier="batch")
        _wait_slots(eng, 2)
        rt = eng.submit(rp, max_new_tokens=8, tier="realtime")
        ids = [rt.result(timeout=300), b1.result(timeout=300),
               b2.result(timeout=300)]
        pre = (rt.preemptions, b1.preemptions + b2.preemptions)
        if side == "jax":
            count = jmetrics.counter("serving.preemptions").get(
                replica=eng.replica, tier="batch", reason="qos")
        else:
            st = eng.stats()
            count = st["preemptions"]["qos"]
            assert st["qos"]["preemptions_by_tier"] == {"qos@batch": count}
    return ids, pre, count, (rp, bp1, bp2)


@pytest.mark.parametrize("extra", [
    {}, {"kv_dtype": "int8"}, {"prefill_chunk_tokens": 8},
    {"speculative_k": 3}], ids=["plain", "int8", "chunked", "spec"])
def test_preemption_resume_parity(jax_model, model, extra):
    """A realtime arrival evicts a running batch request; every request's
    greedy ids equal an uninterrupted run's and the JAX engine's, with
    JAX's preemption count (one)."""
    n = 20 if "prefill_chunk_tokens" in extra else 6
    want = _preempt_run("jax", jax_model, extra, n)
    got = _preempt_run("torch", model, extra, n)
    assert got[:3] == want[:3]
    assert got[1] == (0, 1) and got[2] == 1
    with _engine("torch", model, **extra) as eng:
        ref = [eng.generate(p, max_new_tokens=k, timeout=300)
               for p, k in zip(got[3], (8, 30, 30))]
    assert got[0] == ref


def _brownout_cfg(m):
    return m.QoSConfig(tiers=(
        m.TierPolicy("realtime", priority=2, weight=8, preemptible=False,
                     slo=(slo if m is qos else jslo).SLOPolicy(
                         ttft_s=1e-6, objective=0.9, window=8)),
        m.TierPolicy("standard", priority=1, weight=3, shed_burn_rate=4.0),
        m.TierPolicy("batch", priority=0, weight=1, shed_burn_rate=2.0),
    ), default_tier="standard")


def test_brownout_sheds_low_tiers_and_degrades_health(jax_model, model):
    """An impossible realtime SLO drives the protected tier's burn rate to
    10; batch and standard then shed with reason ``brownout`` while
    realtime still flows, as in the JAX engine."""
    out = {}
    for side, mdl, m, rej in (("jax", jax_model, jqos, JRejected),
                              ("torch", model, qos, RequestRejectedError)):
        with _engine(side, mdl, qos=_brownout_cfg(m),
                     replica=f"{side}-brownout") as eng:
            for i in range(3):
                eng.generate(_prompt(4, 30 + i), max_new_tokens=2,
                             tier="realtime", timeout=300)
            burn = eng.qos_burn_rate()
            time.sleep(0.06)                  # the brownout cache is ~50 ms
            reasons = []
            for tier in ("batch", "standard"):
                with pytest.raises(rej) as ei:
                    eng.submit(_prompt(4, 40), max_new_tokens=2, tier=tier)
                reasons.append(ei.value.reason)
            flows = len(eng.generate(_prompt(4, 41), max_new_tokens=2,
                                     tier="realtime", timeout=300))
            hz = eng.health_state()
            if side == "jax":
                shed = [jmetrics.counter("serving.load_shed").get(
                    replica=eng.replica, reason="brownout", tier=t)
                    for t in ("batch", "standard")]
                bo = eng._statusz()["qos"]["brownout"]
            else:
                lbt = eng.stats()["qos"]["load_shed_by_tier"]
                shed = [lbt.get(f"brownout@{t}") for t in ("batch",
                                                            "standard")]
                bo = eng.stats()["qos"]["brownout"]
            out[side] = (burn, reasons, flows, hz, shed, bo["level"],
                         bo["shed"])
    assert out["torch"] == out["jax"]
    burn, reasons, flows, hz, shed, level, shed_tiers = out["torch"]
    assert burn == pytest.approx(10.0) and flows == 2
    assert reasons == ["brownout"] * 2 and shed == [1, 1]
    assert hz["state"] == "degraded"
    assert any(r.startswith("brownout:L3:preempt") for r in hz["reasons"])
    assert level == 3 and shed_tiers == ["batch", "standard"]


def test_per_tier_queue_cap(jax_model, model):
    out = {}
    for side, mdl, m, rej in (("jax", jax_model, jqos, JRejected),
                              ("torch", model, qos, RequestRejectedError)):
        cfg = m.QoSConfig(tiers=(
            m.TierPolicy("realtime", priority=2, weight=8, preemptible=False),
            m.TierPolicy("standard", priority=1, weight=3, shed_burn_rate=4.0),
            m.TierPolicy("batch", priority=0, weight=1, shed_burn_rate=2.0,
                         max_queue=1),
        ), default_tier="standard")
        with _engine(side, mdl, num_slots=1, qos=cfg) as eng:
            busy = eng.submit(_prompt(4, 50), max_new_tokens=40,
                              tier="realtime")
            _wait_slots(eng, 1)
            q1 = eng.submit(_prompt(4, 51), max_new_tokens=2, tier="batch")
            with pytest.raises(rej) as ei:
                eng.submit(_prompt(4, 52), max_new_tokens=2, tier="batch")
            q2 = eng.submit(_prompt(4, 53), max_new_tokens=2,
                            tier="standard")
            out[side] = (ei.value.reason,
                         [h.result(timeout=300) for h in (busy, q1, q2)])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "queue_full"


def test_per_tier_deadline_estimation(model):
    """The estimate uses the submitting tier's own EMA and only the queued
    requests at the same or higher priority."""
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                        max_model_len=MAXLEN, qos=True)
    eng._progress_t = time.monotonic()
    for _ in range(4):
        eng._queue.append(_req("batch"))
    eng._ema_request_s = 5.0
    eng._tier_ema = {"batch": 5.0, "realtime": 0.05}
    with pytest.raises(RequestRejectedError) as ei:
        eng._check_deadline_meetable(1.0, tier=None)
    assert ei.value.reason == "deadline_unmeetable"
    eng._check_deadline_meetable(1.0, tier="realtime")
    eng._check_deadline_meetable(1.0, tier="standard")
    with pytest.raises(RequestRejectedError):
        eng._check_deadline_meetable(1.0, tier="batch")
    for _ in range(5):
        eng._queue.append(_req("realtime"))
    eng._check_deadline_meetable(1.0, tier="realtime")
    with pytest.raises(RequestRejectedError):
        eng._check_deadline_meetable(0.1, tier="realtime")
    assert eng.stats()["qos"]["load_shed_by_tier"] == {
        "deadline_unmeetable@batch": 1, "deadline_unmeetable@realtime": 1}


def test_engine_slo_accountant(model):
    """``slo=`` accounts every finished request; an expired one is a miss
    by definition."""
    pol = slo.SLOPolicy(ttft_s=60.0, objective=0.5, window=16)
    eng = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                        max_model_len=MAXLEN, slo=pol)
    with eng:
        for i in range(3):
            eng.generate(_prompt(4, 60 + i), max_new_tokens=3, timeout=300)
        h = eng.submit(_prompt(4, 70), max_new_tokens=20, deadline_s=0.0)
        h.result(timeout=300)
    assert h.status == "expired"
    summ = eng.slo_accountant.summary()
    assert summ["evaluated"] == 4 and summ["met"] == 3
    assert summ["window"]["burn_rate"] == pytest.approx(0.5)
    assert eng.stats()["slo"] == summ
    with pytest.raises(TypeError):
        ServingEngine(model, device="cpu", page_size=PS, slo="fast")
