"""PyTorch port, numerics capture and TrainStep observability, held
against the JAX package's ``observability.numerics``, ``amp.debugging``,
``GradScaler`` metrics and probed ``TrainStep`` in one process.

Mirrors ``tests/test_numerics_observability.py`` (probe math, checker
config, probe tokens, ``collect_operator_stats``, the facade, the scaler
series, probe byte-identity, the nan-inject dump naming), leaving out the
supervisor tests (``resilience/supervisor.py`` is not ported) and the
serving-guard ones (ported with the engine's guard).  Site names are the
reference's — qualified module paths, class names lower-cased with
``#k`` on repeats — and are held equal to JAX's site for site; stats
rows within rtol 1e-4 (f32 forward / backward of two implementations),
except the zero fraction of the qkv bias gradients, whose key slice is
zero in exact arithmetic and rounding noise on either side.
"""

import glob
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import flight_recorder as jflight
from paddle_tpu.observability import numerics as jnum
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import amp, jit, nn, optimizer
from paddle_tpu_torch.observability import (faults, flight_recorder,
                                            numerics, tracing)
from paddle_tpu_torch.profiler import metrics as prof_metrics
from paddle_tpu_torch.resilience.retry import NumericFault, classify_failure
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

GPT_CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64)
ROW_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_numerics_state(tmp_path):
    """Fresh checker / fault / flight state per test, in both packages."""
    for f, n in ((faults, numerics), (jfaults, jnum)):
        f.clear()
        n.reset()
    recs = [m.get_flight_recorder() for m in (flight_recorder, jflight)]
    old = [(r.dir, r.last_dump_path) for r in recs]
    for r, sub in zip(recs, ("flight", "jflight")):
        r.dir = str(tmp_path / sub)
    yield
    for r, (d, last) in zip(recs, old):
        r.dir, r.last_dump_path = d, last
    for f, n in ((faults, numerics), (jfaults, jnum)):
        f.clear()
        n.reset()


def _tiny_steps(b=8, din=8, ncls=4):
    """The reference's tiny probed step, in both packages from one init:
    Linear(8, 16) -> ReLU -> Linear(16, 4), AdamW, CrossEntropyLoss."""
    paddle.seed(7)
    jm = jnn.Sequential(jnn.Linear(din, 16), jnn.ReLU(), jnn.Linear(16, ncls))
    tm = torch.nn.Sequential(nn.Linear(din, 16), torch.nn.ReLU(),
                             nn.Linear(16, ncls))
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    js = paddle.jit.TrainStep(
        jm, jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters()),
        loss_fn=jnn.CrossEntropyLoss())
    ts = jit.TrainStep(
        tm, optimizer.AdamW(learning_rate=1e-2, parameters=tm.parameters()),
        loss_fn=nn.CrossEntropyLoss())
    x = np.random.RandomState(0).randn(b, din).astype("float32")
    y = np.random.RandomState(1).randint(0, ncls, (b,)).astype("int64")
    return (js, (paddle.to_tensor(x), paddle.to_tensor(y)),
            ts, (torch.from_numpy(x), torch.from_numpy(y)))


def _numeric_dumps(mod=flight_recorder):
    d = mod.get_flight_recorder().dir
    return sorted(glob.glob(os.path.join(d, "flight_pid*_numerics_*.json")))


# =============================================================== probe math
def test_stats_row_probe_math():
    x = np.array([1.0, -2.0, 0.0, np.nan, np.inf, 4.0], np.float32)
    s = numerics.tensor_stats(x)
    assert s == jnum.tensor_stats(x)
    assert s["nonfinite"] == 2.0
    assert s["absmax"] == 4.0                       # finite values only
    assert s["rms"] == pytest.approx(np.sqrt(21.0 / 6.0), rel=1e-6)
    assert s["zero_frac"] == pytest.approx(0.5)
    assert s["overflow_frac"] == pytest.approx(2.0 / 6.0)
    c = numerics.tensor_stats(np.ones((4,), np.float32))
    assert c["nonfinite"] == 0.0 and c["zero_frac"] == 0.0
    assert c["rms"] == pytest.approx(1.0)


def test_stats_row_low_dtype_fracs():
    x = np.array([1e-6, 1.0, 1e5], np.float32)
    s = numerics.tensor_stats(x, low_dtype="float16")
    assert s == pytest.approx(jnum.tensor_stats(x, low_dtype="float16"))
    assert s["underflow_frac"] == pytest.approx(1.0 / 3.0)
    assert s["overflow_frac"] == pytest.approx(1.0 / 3.0)
    s2 = numerics.tensor_stats(x, low_dtype="bfloat16")
    assert s2["underflow_frac"] == 0.0 and s2["overflow_frac"] == 0.0


def test_tensor_checker_config_validation_and_filters():
    with pytest.raises(ValueError):
        numerics.TensorCheckerConfig(level="loud")
    assert numerics.TensorCheckerConfig(cadence=0).cadence == 1
    cfg = numerics.TensorCheckerConfig(include="decoder", exclude=("embed",))
    assert cfg.include == ("decoder",)
    assert cfg.match("decoder.layer0")
    assert not cfg.match("decoder.embed")     # exclude beats include
    assert not cfg.match("encoder.layer0")    # not in include
    assert numerics.TensorCheckerConfig().match("anything")
    assert numerics.TensorCheckerConfig().nan_inject_site is None


def test_probe_token_and_config_defaults():
    assert numerics.probe_token() == 0
    assert numerics.probe_cadence() == 1
    assert numerics.level() == "warn"
    assert not numerics.serving_guard_default()
    cfg = numerics.enable_tensor_checker(level="dump", cadence=3,
                                         low_dtype="float16",
                                         serving_guard=True)
    t1 = numerics.probe_token()
    assert t1 != 0
    assert numerics.probe_cadence() == 3
    assert numerics.low_dtype() == "float16"
    assert numerics.serving_guard_default()
    assert numerics.config() is cfg
    st = numerics.statusz()
    assert st["cadence"] == 3 and st["probe_token"] == t1
    numerics.disable_tensor_checker()
    assert numerics.probe_token() == 0
    numerics.enable_tensor_checker(level="warn")
    assert numerics.probe_token() not in (0, t1)


# ================================================================ eager API
def test_check_numerics_warn_level_counts():
    c0 = prof_metrics.counter("numerics.checks").get() or 0
    x = torch.tensor([float("nan"), 1.0])
    with pytest.warns(RuntimeWarning, match="nonfinite"):
        s = numerics.check_numerics(x, "probe")
    assert s["nonfinite"] == 1.0
    assert (prof_metrics.counter("numerics.checks").get() or 0) == c0 + 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        numerics.check_numerics(torch.ones(2))
    assert (prof_metrics.counter("numerics.checks").get() or 0) == c0 + 1


def test_check_numerics_abort_raises_numeric():
    numerics.enable_tensor_checker(level="abort")
    with pytest.raises(FloatingPointError) as ei:
        numerics.check_numerics(np.array([np.inf], np.float32), "logits")
    assert classify_failure(ei.value) == "numeric"
    assert classify_failure(NumericFault("nan", site="0")) == "numeric"


def test_check_numerics_dump_once_per_episode():
    numerics.enable_tensor_checker(level="dump")
    bad = np.array([np.nan, np.nan], np.float32)
    numerics.check_numerics(bad, "act")
    assert len(_numeric_dumps()) == 1
    numerics.check_numerics(bad, "act")          # same episode: no new dump
    assert len(_numeric_dumps()) == 1
    numerics.check_numerics(np.ones((2,), np.float32), "act")  # re-arms
    numerics.check_numerics(bad, "act")
    assert len(_numeric_dumps()) == 2
    doc = json.load(open(_numeric_dumps()[0]))
    assert doc["reason"] == "numerics"
    assert doc["extra"]["kind"] == "nonfinite"
    assert doc["extra"]["site"] == "act"
    assert doc["extra"]["stats"][0]["nonfinite"] == 2.0


def test_collect_operator_stats_matches_jax():
    """Per-sublayer sites ("0", "1") and their stats rows equal the JAX
    collector's; the report renders; non-finite outputs are checked on
    exit at the active level."""
    paddle.seed(3)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh())
    tm = torch.nn.Sequential(nn.Linear(4, 8), torch.nn.Tanh())
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    x = np.random.RandomState(0).randn(2, 4).astype("float32")
    with numerics.collect_operator_stats(model=tm) as col:
        tm(torch.from_numpy(x))
    with jnum.collect_operator_stats(model=jm) as jcol:
        jm(paddle.to_tensor(x))
    s, js = col.summary(), jcol.summary()
    assert list(s) == list(js) == ["0", "1", "sequential"]
    for site in s:
        assert s[site] == pytest.approx(js[site], rel=1e-5, abs=1e-7)
    assert s["1"]["absmax"] <= 1.0               # tanh range
    rep = col.report()
    assert rep.splitlines()[0].startswith("site") and "absmax" in rep
    # without a model, sites are the class names with #k on repeats
    m2 = torch.nn.Sequential(nn.Linear(4, 4), nn.Linear(4, 4))
    with numerics.collect_operator_stats() as col2:
        m2(torch.from_numpy(x))
    assert list(col2.summary()) == ["linear", "linear#1", "sequential"]
    xn = torch.full((2, 4), float("nan"))
    with pytest.warns(RuntimeWarning):
        with numerics.collect_operator_stats(model=tm):
            tm(xn)
    # the tap is off outside a region: no hook left behind
    assert numerics._HOOK is None


def test_amp_debugging_facade():
    from paddle_tpu_torch.amp import debugging as dbg

    assert dbg.TensorCheckerConfig is numerics.TensorCheckerConfig
    assert dbg.enable_tensor_checker is numerics.enable_tensor_checker
    assert dbg.check_numerics is numerics.check_numerics
    assert dbg.collect_operator_stats is numerics.collect_operator_stats
    assert dbg.enable_operator_stats_collection is \
        numerics.collect_operator_stats
    assert dbg.OperatorStatsCollector is numerics.OperatorStatsCollector
    assert set(dbg.__all__) == set(__import__(
        "paddle_tpu.amp.debugging", fromlist=["x"]).__all__)


# =============================================================== GradScaler
def test_grad_scaler_deferred_sync_and_metrics():
    torch.manual_seed(1)
    m = nn.Linear(4, 2)
    o = optimizer.Momentum(learning_rate=0.1, parameters=m.parameters())
    sc = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=100)
    x = torch.ones(2, 4)
    sc.scale(m(x).sum()).backward()
    p0 = o._parameter_list[0]
    p0.grad.fill_(float("inf"))
    f0 = prof_metrics.counter("amp.found_inf").get() or 0
    d0 = prof_metrics.counter("amp.scale_decr").get() or 0
    w0 = m.weight.detach().clone()
    sc.unscale_(o)
    # the verdict stays on the device: no host sync in unscale_
    assert isinstance(sc._found_dev, torch.Tensor)
    sc.step(o)                                   # resolves once, skips
    assert torch.equal(m.weight.detach(), w0)
    sc.update()
    assert sc._scale == 4.0
    assert (prof_metrics.counter("amp.found_inf").get() or 0) == f0 + 1
    assert (prof_metrics.counter("amp.scale_decr").get() or 0) == d0 + 1
    assert prof_metrics.gauge("amp.loss_scale").get() == 4.0
    nz = numerics.statusz()["amp"]
    assert set(nz) == {"loss_scale", "found_inf", "scale_decr"}
    assert nz["loss_scale"] == 4.0


def test_grad_scaler_scale_trajectory_matches_jax():
    """The same poisoned schedule through both scalers: the same scale
    after every cycle, and the gauge follows."""
    paddle.seed(2)
    jm = jnn.Linear(4, 2)
    tm = nn.Linear(4, 2)
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    jo = jopt.Momentum(learning_rate=0.01, parameters=jm.parameters())
    to = optimizer.Momentum(learning_rate=0.01, parameters=tm.parameters())
    kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    jsc, tsc = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    x = np.ones((2, 4), np.float32)

    def cycle(poison):
        jo.clear_grad()
        jsc.scale(jm(paddle.to_tensor(x)).sum()).backward()
        to.clear_grad()
        tsc.scale(tm(torch.from_numpy(x)).sum()).backward()
        if poison:
            p = jo._parameter_list[0]
            p.grad._value = jnp.full(p.grad._value.shape, jnp.nan)
            to._parameter_list[0].grad.fill_(float("nan"))
        for sc, o in ((jsc, jo), (tsc, to)):
            sc.step(o)
            sc.update()
        return tsc._scale, jsc._scale

    for poison, want in ((False, 8.0), (False, 16.0), (True, 8.0),
                         (False, 8.0), (False, 16.0)):
        assert cycle(poison) == (want, want)
    assert prof_metrics.gauge("amp.loss_scale").get() == 16.0
    np.testing.assert_allclose(tm.weight.detach().numpy().T,
                               np.asarray(jm.weight._value), rtol=1e-5,
                               atol=1e-6)


# ============================================================ TrainStep probes
def _total(name):
    m = prof_metrics.get_registry().get(name)
    return m.total() if m else 0.0


def test_trainstep_probe_byte_identity_and_stats():
    """Off: the unprobed step.  On: a distinct variant (one more compile,
    no retrace) whose losses equal the unprobed step's bit for bit, with
    the reference's sites and stats rows (held to JAX's); off again: the
    original variant, nothing new."""
    js, jb, ts, tb = _tiny_steps()
    _, _, ts2, tb2 = _tiny_steps()
    c0, r0 = _total("train_step.compiles"), _total("train_step.retraces")
    plain = [ts2(*tb2) for _ in range(4)]
    assert _total("train_step.compiles") == c0 + 1
    probed = [ts(*tb), ts(*tb)]
    [float(js(*jb)) for _ in range(2)]
    numerics.enable_tensor_checker(level="warn")
    jnum.enable_tensor_checker(level="warn")
    probed.append(ts(*tb))
    jl = float(js(*jb))
    numerics.poll()
    jnum.poll()
    ent, jent = numerics.latest(ts._perf_tag), jnum.latest(js._perf_tag)
    assert ent["step"] == jent["step"] == 3
    probed.append(ts(*tb))
    assert _total("train_step.compiles") == c0 + 3  # plain x2 + probed
    assert _total("train_step.retraces") == r0      # a toggle stays quiet
    # probes change nothing the step computes
    assert all(torch.equal(a, b) for a, b in zip(probed, plain))
    assert float(probed[2]) == pytest.approx(jl, rel=1e-5)
    assert ent["sites"] == jent["sites"]
    sites = ent["sites"]
    assert sites[:3] == ("0", "1", "2") and "loss" in sites
    assert "crossentropyloss" in sites
    assert [s for s in sites if s.startswith("grad/")] == \
        ["grad/0.bias", "grad/0.weight", "grad/2.bias", "grad/2.weight"]
    assert ent["table"].shape == (len(sites), numerics.NSTATS)
    np.testing.assert_allclose(ent["table"], jent["table"], **ROW_TOL)
    assert prof_metrics.gauge("numerics.rms").get(
        site=ts._perf_tag, tensor="loss") is not None
    assert prof_metrics.gauge("numerics.nonfinite").get(
        site=ts._perf_tag, tensor="0") == 0.0
    numerics.disable_tensor_checker()
    ts(*tb)
    assert _total("train_step.compiles") == c0 + 3
    assert _total("train_step.retraces") == r0
    assert len(ts._variants) == 2


def test_gpt_trainstep_probe_rows_match_jax():
    """GPT-tiny (the reference tests' size) probed through TrainStep: the
    site list — embeddings, every module of every block, the loss, the
    sorted gradient rows — equals the JAX step's, and the rows agree."""
    paddle.seed(0)
    jm = JGPT(**GPT_CFG)
    tm = GPTForCausalLM(device="cpu", **GPT_CFG)
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    js = paddle.jit.TrainStep(
        jm, jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()),
        loss_fn=None)
    ts = jit.TrainStep(
        tm, optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters()),
        loss_fn=None)
    ids = np.random.RandomState(0).randint(0, 96, (2, 16)).astype("int64")
    numerics.enable_tensor_checker(level="warn")
    jnum.enable_tensor_checker(level="warn")
    jl = float(js({"input_ids": paddle.to_tensor(ids),
                   "labels": paddle.to_tensor(ids)}))
    tl = float(ts({"input_ids": torch.from_numpy(ids),
                   "labels": torch.from_numpy(ids)}))
    assert tl == pytest.approx(jl, rel=1e-5)
    numerics.poll()
    jnum.poll()
    ent, jent = numerics.latest(ts._perf_tag), jnum.latest(js._perf_tag)
    assert ent["sites"] == jent["sites"]
    sites = ent["sites"]
    assert sites[:4] == ("gpt.word_embeddings", "gpt.position_embeddings",
                         "gpt.drop", "gpt.layers.0.ln1")
    assert "gpt.layers.1" in sites and "gptforcausallm" in sites
    noise = [i for i, s in enumerate(sites) if s.endswith("qkv.bias")]
    t, jt = ent["table"].copy(), jent["table"].copy()
    t[noise, 3] = jt[noise, 3] = 0.0            # the key slice's zeros
    np.testing.assert_allclose(t, jt, rtol=1e-3, atol=1e-6)


def test_trainstep_nan_inject_one_dump_names_first_layer():
    js, jb, ts, tb = _tiny_steps()
    numerics.enable_tensor_checker(level="dump")
    ts(*tb)                                      # clean probed step
    numerics.poll()
    assert len(_numeric_dumps()) == 0
    faults.inject("numerics.nan_inject", times=1)
    ts(*tb)                                      # poisoned at site "0"
    numerics.poll()
    files = _numeric_dumps()
    assert len(files) == 1                       # exactly ONE dump
    doc = json.load(open(files[0]))
    assert doc["reason"] == "numerics"
    assert doc["extra"]["kind"] == "nonfinite"
    assert doc["extra"]["site"] == "0"           # first offending layer
    assert doc["extra"]["stream"] == ts._perf_tag
    by_tensor = {r["tensor"]: r for r in doc["extra"]["stats"]}
    assert by_tensor["0"]["nonfinite"] > 0
    eps = numerics.monitor().episodes()
    assert eps and eps[-1].kind == "nonfinite" and eps[-1].site == "0"
    assert (prof_metrics.counter("observability.flight_dumps").get(
        reason="numerics") or 0) >= 1
    # the same fault through the JAX step names the same site
    jnum.enable_tensor_checker(level="dump")
    js(*jb)
    jfaults.inject("numerics.nan_inject", times=1)
    js(*jb)
    jnum.poll()
    jdoc = json.load(open(_numeric_dumps(jflight)[0]))
    assert jdoc["extra"]["site"] == doc["extra"]["site"]
    # the NaN reached the parameters; the episode stays open: no storm
    for _ in range(2):
        ts(*tb)
        numerics.poll()
    assert len(_numeric_dumps()) == 1


def test_nan_inject_site_names_a_later_layer():
    _, _, ts, tb = _tiny_steps()
    numerics.enable_tensor_checker(level="dump", nan_inject_site="2")
    faults.inject("numerics.nan_inject", times=1)
    ts(*tb)
    numerics.poll()
    ent = numerics.latest(ts._perf_tag)
    rows = dict(zip(ent["sites"], ent["table"][:, 0]))
    assert rows["0"] == 0 and rows["1"] == 0 and rows["2"] > 0
    assert numerics.monitor().episodes()[-1].site == "2"


def test_poll_abort_raises_numeric_fault():
    _, _, ts, tb = _tiny_steps()
    numerics.enable_tensor_checker(level="abort")
    ts(*tb)                                      # clean: no raise
    numerics.poll()
    faults.inject("numerics.nan_inject", times=1)
    with pytest.raises(NumericFault) as ei:
        ts(*tb)                                  # maybe_poll may raise...
        numerics.poll()                          # ...else this does
    assert ei.value.site == "0"
    assert ei.value.stream == ts._perf_tag
    assert classify_failure(ei.value) == "numeric"


def test_probe_cadence_probes_every_nth_step():
    _, _, ts, tb = _tiny_steps()
    numerics.enable_tensor_checker(level="warn", cadence=3)
    steps = []
    for i in range(6):
        ts(*tb)
        numerics.poll()
        steps.append(numerics.latest(ts._perf_tag)["step"])
    # probed at step counts 0 and 3, submitted as steps 1 and 4
    assert steps == [1, 1, 1, 4, 4, 4]
    assert len(ts._variants) == 2               # unprobed + probed


def test_probes_with_accumulation_and_scaler_record_loss_and_grads():
    """With accumulate_steps > 1 the reference records no activation rows;
    with a scaler the gradient rows are the UNSCALED, averaged gradients
    (held to a plain backward of the same two micro-batches, 1e-5)."""
    torch.manual_seed(7)
    tm = torch.nn.Sequential(nn.Linear(8, 4))
    ref = torch.nn.Sequential(nn.Linear(8, 4))
    ref.load_state_dict(tm.state_dict())
    o = optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    st = jit.TrainStep(tm, o, loss_fn=nn.CrossEntropyLoss(),
                       accumulate_steps=2,
                       scaler=amp.GradScaler(init_loss_scaling=1024.0))
    x = torch.randn(8, 8)
    y = torch.randint(0, 4, (8,))
    numerics.enable_tensor_checker(level="warn")
    st(x, y)
    numerics.poll()
    ent = numerics.latest(st._perf_tag)
    assert ent["sites"] == ("loss", "grad/0.bias", "grad/0.weight")
    loss_fn = nn.CrossEntropyLoss()
    for i in range(2):
        (loss_fn(ref(x[4 * i:4 * i + 4]), y[4 * i:4 * i + 4]) / 2).backward()
    for row, p in zip(ent["table"][1:], (ref[0].bias, ref[0].weight)):
        want = numerics.tensor_stats(p.grad)
        assert row[2] == pytest.approx(want["rms"], rel=1e-5)
        assert row[1] == pytest.approx(want["absmax"], rel=1e-5)


# ======================================================= TrainStep metrics
def test_trainstep_metric_families_spans_and_retrace_warning():
    _, _, ts, tb = _tiny_steps()
    reg = prof_metrics.get_registry()
    c0, r0 = _total("train_step.compiles"), _total("train_step.retraces")
    h = reg.get("train_step.step_seconds")
    n0 = h.labels().count if h is not None else 0
    tr = tracing.Tracer().start()
    try:
        for _ in range(3):
            ts(*tb)
        with pytest.warns(UserWarning, match="retrace"):
            ts(tb[0][:4], tb[1][:4])
    finally:
        tr.stop()
    assert _total("train_step.compiles") == c0 + 2
    assert _total("train_step.retraces") == r0 + 1
    # steady intervals only: the 2nd call follows a first call (whose
    # wall is a compile), so only the 2nd -> 3rd interval is observed
    assert reg.get("train_step.step_seconds").labels().count == n0 + 1
    assert reg.get("train_step.compile_seconds").get() > 0
    # params 8x16+16 + 16x4+4 (f32) and AdamW's two moments each
    nparam = 8 * 16 + 16 + 16 * 4 + 4
    assert reg.get("train_step.donated_bytes").get() >= 3 * 4 * nparam
    spans = tr.find("jit.train_step")
    assert len(spans) == 4
    assert [s.attrs.get("new_variant") for s in spans] == \
        [True, False, False, True]
    cost = ts.cost_analysis()
    assert cost is not None and cost["flops"] > 0
    assert reg.get("train_step.flops_per_step").get() == cost["flops"]
