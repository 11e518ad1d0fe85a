"""PyTorch port, API faults against the reference (F4-F9): each call is
made in both packages on the CPU, with the same numpy inputs, and the two
must agree.

- F4: ``nn.Embedding(..., sparse, weight_attr, name)``, ``nn.LayerNorm(...,
  weight_attr, bias_attr, name)`` (``False`` drops that half of the
  affine), ``nn.RMSNorm(..., weight_attr, name)``, and ``name`` on
  ``F.gelu``, ``F.rms_norm`` and ``F.scaled_dot_product_attention``.
- F5: ``serving.SamplingParams(temperature, seed=None)``.
- F6: ``ContinuousBatchingPredictor(model, config, ..., engine=...)``.
- F7: ``PADDLE_SERVING_WATCHDOG_S`` arms the engine's watchdog and sets
  ``ServingWatchdog``'s default deadline; ``PADDLE_TRAINSTEP_COST``
  resolves a ``TrainStep`` variant's cost at its first dispatch.
- F8: the re-exports of ``serving``, ``observability``, ``nn`` and
  ``utils``, one case per name.
- F9: ``nn.functional.flash_attention`` forward and gradient against the
  reference's and ``jax.grad`` on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.observability as jobs
import paddle_tpu.optimizer as jopt
import paddle_tpu.serving as jserving
import paddle_tpu.utils as jutils
from paddle_tpu.observability.watchdog import ServingWatchdog as JWatchdog
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.observability as tobs
import paddle_tpu_torch.serving as tserving
import paddle_tpu_torch.utils as tutils
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.observability.watchdog import ServingWatchdog as TWatchdog
from paddle_tpu_torch.text.models import GPTForCausalLM as TGPT

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.numpy())


# --------------------------------------------------------------------- F4
def test_layer_norm_without_affine_matches_reference():
    """``weight_attr=False, bias_attr=False``: no parameters in either
    package, and the outputs agree."""
    x = _rand(0, 3, 5, 16)
    t = tnn.LayerNorm(16, weight_attr=False, bias_attr=False, name="ln")
    j = jnn.LayerNorm(16, weight_attr=False, bias_attr=False, name="ln")
    assert list(t.parameters()) == [] and list(j.parameters()) == []
    assert t.weight is None and t.bias is None
    np.testing.assert_allclose(_np(t(torch.from_numpy(x))),
                               _np(j(paddle.to_tensor(x))), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layer", ["layer_norm", "rms_norm", "embedding"])
def test_weight_attr_initializer_matches_reference(layer):
    """An initializer given through ``weight_attr`` draws the weight in
    both packages (a constant, so both draw the same values); LayerNorm's
    ``bias_attr`` too, and Embedding's padding row is zero after it."""
    def attr(mod, v):
        return mod.ParamAttr(initializer=mod.initializer.Constant(v))

    if layer == "embedding":
        ids = np.array([[0, 3, 7], [2, 2, 0]])
        mods = [m.Embedding(10, 6, padding_idx=0, sparse=True,
                            weight_attr=attr(m, 0.25), name="emb")
                for m in (tnn, jnn)]
        outs = [mods[0](torch.from_numpy(ids)), mods[1](paddle.to_tensor(ids))]
        assert _np(mods[0].weight)[0].tolist() == [0.0] * 6
    else:
        x = _rand(1, 4, 16)
        if layer == "layer_norm":
            mods = [m.LayerNorm(16, weight_attr=attr(m, 0.5),
                                bias_attr=attr(m, -0.25), name="ln")
                    for m in (tnn, jnn)]
        else:
            mods = [m.RMSNorm(16, weight_attr=attr(m, 0.5), name="rms")
                    for m in (tnn, jnn)]
        outs = [mods[0](torch.from_numpy(x)), mods[1](paddle.to_tensor(x))]
    np.testing.assert_array_equal(_np(mods[0].weight), _np(mods[1].weight))
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), rtol=1e-5,
                               atol=1e-5)


def test_functionals_take_name():
    """``name=`` on F.gelu, F.rms_norm and F.scaled_dot_product_attention,
    with the same results in both packages."""
    x = _rand(2, 2, 6, 3, 8)
    w = _rand(3, 8)
    tx, jx = torch.from_numpy(x), paddle.to_tensor(x)
    pairs = [
        (TF.gelu(tx, name="g"), JF.gelu(jx, name="g")),
        (TF.rms_norm(tx, torch.from_numpy(w), 1e-6, name="r"),
         JF.rms_norm(jx, paddle.to_tensor(w), 1e-6, name="r")),
        (TF.scaled_dot_product_attention(tx, tx, tx, is_causal=True,
                                         name="a"),
         JF.scaled_dot_product_attention(jx, jx, jx, is_causal=True,
                                         name="a"))]
    for t, j in pairs:
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- F5
def test_sampling_params_take_a_reserved_seed():
    t = tserving.SamplingParams(0.5, seed=1)
    j = jserving.SamplingParams(0.5, seed=1)
    assert (t.temperature, t.seed) == (j.temperature, j.seed) == (0.5, 1)
    assert tserving.SamplingParams().seed is jserving.SamplingParams().seed \
        is None


# --------------------------------------------------------------------- F6
@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    torch.manual_seed(0)
    return TGPT(device="cpu", **CFG).eval(), JGPT(**CFG).eval()


def test_predictor_takes_config_and_engine(models):
    """``(model, config, ..., engine=)``: the engine is used as is, the
    config recorded, and a second positional argument no longer lands in
    ``max_new_tokens``; the port's predictor serves through the given
    engine (its greedy ids are the engine's own)."""
    tm, jm = models
    cfg = object()
    teng = tserving.ServingEngine(tm, device="cpu", num_slots=2, page_size=8,
                                  max_model_len=64)
    jeng = jserving.ServingEngine(jm, num_slots=2, page_size=8,
                                  max_model_len=64, replica="api-faults-cfg")
    preds = [tserving.ContinuousBatchingPredictor(tm, cfg, engine=teng),
             jserving.ContinuousBatchingPredictor(jm, cfg, engine=jeng)]
    for pred, eng in zip(preds, (teng, jeng)):
        assert pred._engine is eng and pred._config is cfg
        assert pred._max_new_tokens == 32
    pred = tserving.ContinuousBatchingPredictor(tm, cfg, max_new_tokens=4,
                                                engine=teng)
    ids = np.array([[5, 9, 11, 2], [7, 3, 0, 0]], np.int64)
    with pred:
        (out,) = pred.run([ids])
        want = [teng.submit(p, max_new_tokens=4).result(timeout=60)
                for p in ([5, 9, 11, 2], [7, 3])]
    assert out[:, 4:].tolist() == want


# --------------------------------------------------------------------- F7
@pytest.mark.parametrize("env,want", [("30", 30.0), ("0", None), ("", None)])
def test_engine_watchdog_armed_from_the_environment(models, monkeypatch, env,
                                                    want):
    """With ``watchdog_s=None`` both engines arm their watchdog from
    ``PADDLE_SERVING_WATCHDOG_S``; 0 or empty means off."""
    monkeypatch.setenv("PADDLE_SERVING_WATCHDOG_S", env)
    tm, jm = models
    engines = [tserving.ServingEngine(tm, device="cpu", num_slots=2,
                                      page_size=8, max_model_len=64),
               jserving.ServingEngine(jm, num_slots=2, page_size=8,
                                      max_model_len=64, replica="api-faults")]
    for eng in engines:
        with eng:
            wd = eng._watchdog
            assert (wd.deadline_s if wd is not None else None) == want


@pytest.mark.parametrize("env,want", [(None, 60.0), ("12.5", 12.5)])
def test_watchdog_default_deadline(models, monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PADDLE_SERVING_WATCHDOG_S", raising=False)
    else:
        monkeypatch.setenv("PADDLE_SERVING_WATCHDOG_S", env)
    assert TWatchdog(object()).deadline_s == JWatchdog(object()).deadline_s \
        == want


@pytest.mark.parametrize("env", ["1", "0"])
def test_train_step_cost_resolved_at_first_dispatch(monkeypatch, env):
    """``PADDLE_TRAINSTEP_COST=1``: the first call of a variant resolves
    its cost, so ``train_step.flops_per_step`` is set after one step in
    both packages; unset ("0"), the port leaves it to the lazy resolve."""
    monkeypatch.setenv("PADDLE_TRAINSTEP_COST", env)
    x, y = _rand(4, 8, 16), _rand(5, 8, 4)

    def loss(out, target):
        return ((out - target) ** 2).mean()

    torch.manual_seed(0)
    tm = tnn.Linear(16, 4)
    tstep = tjit.TrainStep(tm, topt.SGD(learning_rate=0.1,
                                        parameters=tm.parameters()), loss)
    tstep._m_flops.set(0.0)
    tstep(torch.from_numpy(x), torch.from_numpy(y))
    t_flops = tstep._m_flops.get()
    assert (t_flops > 0) == (env == "1")
    if env == "1":
        paddle.seed(0)
        jm = jnn.Linear(16, 4)
        jstep = paddle.jit.TrainStep(jm, jopt.SGD(learning_rate=0.1,
                                                  parameters=jm.parameters()),
                                     loss)
        jstep._m_flops.set(0.0)
        jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        assert jstep._m_flops.get() > 0


# --------------------------------------------------------------------- F8
REEXPORTS = [
    ("serving", n) for n in (
        "Request", "prefix_digest", "make_verifier", "QuantizedGPTAdapter",
        "quantize_model_weights", "calibrate", "MultiTenantEngine",
        "LoRAStore", "LoRAAdapter", "CompiledGrammar", "compile_regex",
        "compile_json_schema")] + [
    ("observability", "collect_operator_stats")] + [
    ("nn", n) for n in ("ClipGradByGlobalNorm", "ClipGradByNorm",
                        "ClipGradByValue")] + [
    ("utils", n) for n in ("SummaryWriter", "try_import", "run_check",
                           "require_version", "deprecated")]


@pytest.mark.parametrize("module,name", REEXPORTS,
                         ids=[f"{m}.{n}" for m, n in REEXPORTS])
def test_reexports_match_reference(module, name):
    """The name is exported where the reference exports it, and is the
    same kind of object (a class in both, or a function in both)."""
    ref = {"serving": jserving, "observability": jobs, "nn": jnn,
           "utils": jutils}[module]
    port = {"serving": tserving, "observability": tobs, "nn": tnn,
            "utils": tutils}[module]
    assert hasattr(ref, name)
    got = getattr(port, name)
    assert isinstance(got, type) == isinstance(getattr(ref, name), type)
    if module == "serving" and name in getattr(ref, "__all__", ()):
        assert callable(got)


def test_small_utils_behave_as_the_reference():
    for u in (tutils, jutils):
        assert u.try_import("math").sqrt(4.0) == 2.0
        with pytest.raises(ImportError, match="nope"):
            u.try_import("no_such_module_here", "nope")
        assert u.require_version("0.0.1") is True

        def f():
            return 3

        assert u.deprecated(update_to="g")(f) is f
    assert tutils.run_check() is True


# --------------------------------------------------------------------- F9
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(causal):
    """F.flash_attention, ``[B, S, H, D]``, against the reference's
    (forward) and jax.grad of it (gradients), float32 on the CPU."""
    B, S, H, D = 2, 40, 3, 16
    q, k, v = (_rand(s, B, S, H, D) for s in (10, 11, 12))
    g = _rand(13, B, S, H, D)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, soft = TF.flash_attention(tq, tk, tv, causal=causal,
                                   return_softmax=True)
    jout, jsoft = JF.flash_attention(*(paddle.to_tensor(a) for a in (q, k, v)),
                                     causal=causal, return_softmax=True)
    assert soft is None and jsoft is None
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)

    from paddle_tpu.ops.flash_attention import flash_attention_fn as jfa_fn

    def loss(q, k, v):
        return jnp.sum(jfa_fn(q, k, v, causal=causal) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    out.backward(torch.from_numpy(g))
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_flash_attention_refuses_training_dropout():
    """Dropout inside the kernel while training raises in both packages;
    in eval mode it is the no-dropout call."""
    x = _rand(14, 1, 8, 2, 8)
    for F_, t in ((TF, torch.from_numpy(x)), (JF, paddle.to_tensor(x))):
        with pytest.raises(NotImplementedError, match="dropout"):
            F_.flash_attention(t, t, t, dropout=0.1, causal=True)
    np.testing.assert_array_equal(
        _np(TF.flash_attention(torch.from_numpy(x), torch.from_numpy(x),
                               torch.from_numpy(x), dropout=0.1,
                               training=False)),
        _np(TF.flash_attention(torch.from_numpy(x), torch.from_numpy(x),
                               torch.from_numpy(x))))
