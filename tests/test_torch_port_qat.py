"""PyTorch port, quantization-aware training and post-training
quantization: fake-quant and its straight-through estimator, the quanters
and observers, QuantConfig, QAT through ``TrainStep``, PTQ, the state-dict
converter on wrapped models, and ``convert_to_int8`` into the int8 serving
engine, each against the JAX package on the same inputs (CPU).

Tolerances are stated per test.  Fake-quant rounding makes a QAT loss a
discontinuous function of the weights: a last-bit difference in an
absmax scale moves the elements at a rounding tie to the next grid point.
So multi-step QAT parity is held to that sensitivity, not to the float
noise of a plain run.  Measured on the f32 GPT-tiny run below, over nine
perturbations of the port's init by 1e-7 relative (rounding-sized noise,
as another CPU's GEMMs would give), the port against JAX moved up to:
first loss 7.1e-5, any of the five losses 6.5e-4, the weights' update
1.7e-2 of its norm, the scales 7.9e-4.  Each gate is about 3x that."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import quantization as jquant
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.quant import quantize_model_weights
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)

GPT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64)
LR, STEPS = 1e-3, 5


def _jt(x, dtype="float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------- fake quant
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_forward_byte_equal_to_jax(dtype):
    """clip(round(x / scale)) * scale with exact .5 ties and clipped
    values; a bf16 x promotes to float32 with the float32 scale, as in
    JAX."""
    rs = np.random.RandomState(0)
    x = (rs.randn(257) * 2).astype("float32")
    x[:6] = [0.5, -1.5, 2.5, 300.0, -300.0, 0.0]
    jx, tx = _jt(x, dtype)
    for scale, bits in ((1.0, 8), (0.0371, 8), (0.5, 4)):
        qmax = 2.0 ** (bits - 1) - 1
        js = jnp.float32(scale)
        want = jquant._fake_quant(jx, js, -qmax, qmax)
        got = tquant._fake_quant(tx, torch.tensor(scale, dtype=torch.float32),
                                 -qmax, qmax)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_ste_mask_matches_jax(bits):
    """The straight-through gradient passes inside |x| <= scale * qmax and
    is zero outside, for the bit width's qmax; no gradient to the scale."""
    qmax = 2.0 ** (bits - 1) - 1
    x = np.array([0.0, 3.0, qmax - 0.1, qmax, qmax + 0.1, -qmax - 0.1, 100.0],
                 np.float32)
    g = np.arange(1, 8, dtype=np.float32)
    jg = jax.vjp(lambda v: jquant._fake_quant(v, jnp.float32(1.0), -qmax, qmax),
                 jnp.asarray(x))[1](jnp.asarray(g))[0]
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(1.0, requires_grad=True)
    tquant._fake_quant(tx, ts, -qmax, qmax).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    assert ts.grad is None
    np.testing.assert_array_equal(tx.grad.numpy() != 0, np.abs(x) <= qmax)


def test_quant_absmax_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(64).astype("float32")
    want = jquant.quant_absmax(paddle.to_tensor(x), bits=8).numpy()
    np.testing.assert_array_equal(tquant.quant_absmax(torch.from_numpy(x)).numpy(), want)
    tx = torch.from_numpy(x).requires_grad_()
    tquant.quant_absmax(tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.ones(64, np.float32))


# -------------------------------------------------------------- quanters
def _quanter_pair(**kw):
    return jquant.FakeQuanterWithAbsMaxObserver(**kw), \
        tquant.FakeQuanterWithAbsMaxObserver(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amp", [0.1, 5.0])
def test_moving_average_quirk_matches_jax(amp, dtype):
    """The running scale restarts from the batch absmax while it is <= 1
    (every call when |x| stays below 1: amp 0.1), and averages with rate
    0.9 once above (amp 5.0).  Outputs and stored scales byte-equal to
    JAX over a sequence of calls, float32 and bf16 inputs; the buffer
    stays float32."""
    jqn, tqn = _quanter_pair()
    rs = np.random.RandomState(2)
    for i in range(4):
        x = (rs.randn(8, 16) * amp * (1 + 0.3 * i)).astype("float32")
        jx, tx = _jt(x, dtype)
        want = jqn(paddle.to_tensor(np.asarray(jx.astype(jnp.float32))).astype(dtype))
        got = tqn(tx)
        np.testing.assert_array_equal(got.float().numpy(), _np(want._value))
        assert tqn.scale.dtype == torch.float32
        np.testing.assert_array_equal(tqn.scale.numpy(), np.asarray(jqn.scale._value))
    absmax = float(np.abs(_np(jx)).max())
    if amp < 1:   # restarted from the last call's absmax
        assert float(tqn.scale) == pytest.approx(absmax, rel=1e-6)
    else:         # a moving average: not the last absmax
        assert float(tqn.scale) != pytest.approx(absmax, rel=1e-3)


def test_eval_mode_quantizes_with_the_new_scale_without_storing():
    jqn, tqn = _quanter_pair(bit_length=4)
    x = (np.random.RandomState(3).randn(32) * 4).astype("float32")
    jqn(paddle.to_tensor(x))
    tqn(torch.from_numpy(x))
    jqn.eval()
    tqn.eval()
    before = tqn.scale.clone()
    x2 = x * 3
    want = jqn(paddle.to_tensor(x2)).numpy()
    np.testing.assert_array_equal(tqn(torch.from_numpy(x2)).numpy(), want)
    assert torch.equal(tqn.scale, before)
    np.testing.assert_array_equal(tqn.scale.numpy(), np.asarray(jqn.scale._value))


def test_absmax_observer_and_ptq_freeze_match_jax():
    jo, to = jquant.AbsmaxObserver(), tquant.AbsmaxObserver()
    rs = np.random.RandomState(4)
    for _ in range(3):
        x = rs.randn(5, 7).astype("float32") * rs.uniform(0.5, 3)
        tx = torch.from_numpy(x)
        assert to(tx) is tx
        jo(paddle.to_tensor(x))
    np.testing.assert_array_equal(to.absmax.numpy(), np.asarray(jo.absmax._value))
    assert to.scale() == jo.scale()
    jf = jquant._FrozenFakeQuant(jo.scale(), jo.bits)
    tf = tquant._FrozenFakeQuant(to.scale(), to.bits)
    x = rs.randn(40).astype("float32") * 4
    np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(),
                                  jf(paddle.to_tensor(x)).numpy())
    assert "_scale_t" not in tf.state_dict()        # an attribute in JAX


def test_quant_config_type_and_layer_overrides_clone_kwargs():
    """add_type_config / add_layer_config resolve per layer; prototypes are
    cloned with their ctor kwargs (bit_length kept), one per layer."""
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = Linear(4, 4)
            self.b = Linear(4, 4)
            self.c = torch.nn.Linear(4, 4)

        def forward(self, x):
            return self.c(self.b(self.a(x)))

    m = M()
    cfg = tquant.QuantConfig(activation=None, weight=None)
    proto4 = tquant.FakeQuanterWithAbsMaxObserver(bit_length=4, moving_rate=0.5)
    cfg.add_type_config(Linear, activation=proto4,
                        weight=tquant.FakeQuanterWithAbsMaxObserver(bit_length=4))
    cfg.add_layer_config(m.b, activation=tquant.FakeQuanterWithAbsMaxObserver(bit_length=6),
                         weight=tquant.FakeQuanterWithAbsMaxObserver(bit_length=6))
    assert cfg._for(m.b)[0].bits == 6 and cfg._for(m.a)[0] is proto4
    q = tquant.QAT(cfg).quantize(m)
    assert q.a.act_quanter.bits == 4 and q.a.weight_quanter.bits == 4
    assert q.a.act_quanter.moving_rate == 0.5
    assert q.b.act_quanter.bits == 6 and q.b.weight_quanter.bits == 6
    assert q.c.act_quanter.bits == 8                 # torch.nn.Linear: default
    assert q.a.act_quanter is not proto4
    assert q.a.act_quanter is not q.b.act_quanter
    lin = Linear(2, 2)
    cfg2 = tquant.QuantConfig()
    cfg2.add_type_config(Linear, activation=None, weight=None)
    cfg2.add_layer_config(lin, activation="A", weight="W")
    assert cfg2._for(lin) == ("A", "W")
    assert cfg2._for(Linear(2, 2)) == (None, None)


def test_wrapper_keeps_the_parameter_and_routes_the_ste_gradient():
    """The inner weight is never written; the weight gradient is the STE's
    (the full gradient inside the clip range, which absmax covers); a
    wrapped Linear matches the JAX one's output (rtol 1e-6: the products
    sum in another order)."""
    paddle.seed(5)
    jm = jquant.QAT(jquant.QuantConfig()).quantize(jnn.Sequential(jnn.Linear(8, 6)))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tquant.QAT(tquant.QuantConfig()).quantize(torch.nn.Sequential(Linear(8, 6)))
    load_paddle_tpu_state_dict(tm, state)
    w0 = tm[0].inner.weight.detach().clone()
    x = np.random.RandomState(6).randn(3, 8).astype("float32")
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(tm[0].inner.weight, w0)
    out.sum().backward()
    xq = tm[0].act_quanter(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(tm[0].inner.weight.grad.numpy(),
                               np.ones((6, 3), np.float32) @ xq.numpy(), rtol=1e-6)


def test_scale_buffers_stay_float32_when_cast():
    """``.to(torch.bfloat16)`` casts parameters, never a quanter's or an
    Int8Linear's float32 scale."""
    m = tquant.QAT(tquant.QuantConfig()).quantize(torch.nn.Sequential(Linear(8, 8)))
    m(torch.randn(4, 8) * 3)
    s = m[0].act_quanter.scale.clone()
    m.to(torch.bfloat16)
    assert m[0].inner.weight.dtype == torch.bfloat16
    assert m[0].act_quanter.scale.dtype == torch.float32
    assert torch.equal(m[0].act_quanter.scale, s)
    m.float()
    tquant.convert_to_int8(m)
    m.to(torch.bfloat16)
    lin = m[0]
    assert isinstance(lin, tquant.Int8Linear)
    assert lin._w_scale.dtype == lin._act_scale.dtype == torch.float32
    assert float(lin._act_scale) == pytest.approx(float(s) / 127, rel=1e-6)
    assert lin.bias.dtype == torch.bfloat16 and lin.weight_int8.dtype == torch.int8


# ------------------------------------------------------- QAT GPT-tiny
def _ids(seed=0, b=2, s=32):
    return np.random.RandomState(seed).randint(0, GPT_CFG["vocab_size"], (b, s)).astype("int64")


def _qat_gpt_pair():
    paddle.seed(0)
    j = jquant.QAT(jquant.QuantConfig()).quantize(JGPT(**GPT_CFG))
    init = {k: np.asarray(v._value) for k, v in j.state_dict().items()}
    t = tquant.QAT(tquant.QuantConfig()).quantize(GPTForCausalLM(device="cpu", **GPT_CFG))
    load_paddle_tpu_state_dict(t, init)
    return j, t, init


def _train_both(amp_level):
    j, t, init = _qat_gpt_pair()
    jo = jopt.AdamW(learning_rate=LR, parameters=j.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(learning_rate=LR, parameters=t.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(j, jo, loss_fn=None, amp_level=amp_level)
    ts = tjit.TrainStep(t, to, loss_fn=None, amp_level=amp_level)
    ids = _ids()
    jl = [float(js({"input_ids": paddle.to_tensor(ids),
                    "labels": paddle.to_tensor(ids)})) for _ in range(STEPS)]
    tl = [float(ts({"input_ids": torch.from_numpy(ids),
                    "labels": torch.from_numpy(ids)})) for _ in range(STEPS)]
    jw = {k: np.asarray(v._value, dtype=np.float32) for k, v in j.state_dict().items()}
    tw = export_paddle_tpu_state_dict(t, jw)
    return (np.asarray(jl), np.asarray(tl), jw, tw, init,
            jquant.extract_scales(j), tquant.extract_scales(t), t)


def _update_diff(jw, tw, init):
    """|w_port - w_jax| over |w_jax - w_init|, over the trained weights."""
    keys = [k for k in jw if not k.endswith(".scale")]
    num = np.sqrt(sum(np.sum((tw[k] - jw[k]) ** 2) for k in keys))
    den = np.sqrt(sum(np.sum((jw[k] - init[k]) ** 2) for k in keys))
    return num / den


def test_qat_gpt_tiny_trainstep_matches_jax_f32():
    """5 QAT TrainSteps (AdamW lr 1e-3, ClipGradByGlobalNorm(1.0)) of
    GPT-tiny from one converted init, 4 wrapped Linears per layer.  Gates
    from the spread in the module docstring (unperturbed: first loss
    equal, all five 2.9e-4, update 1.2e-3, scales 4.9e-5): the first loss
    rtol 3e-4, all five rtol 2e-3, extract_scales keys equal and values
    rtol 3e-3, the weights' update within 5e-2 of its norm."""
    jl, tl, jw, tw, init, js, ts, t = _train_both(None)
    wrappers = [m for m in t.modules() if isinstance(m, tquant._QuantedWrapper)]
    assert len(wrappers) == 4 * GPT_CFG["num_hidden_layers"]
    np.testing.assert_allclose(tl[0], jl[0], rtol=3e-4)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    assert set(ts) == set(js) and len(ts) == 2 * len(wrappers)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=3e-3, err_msg=k)
    assert _update_diff(jw, tw, init) < 5e-2
    assert {b.dtype for b in t.buffers()} == {torch.float32}


def test_qat_gpt_tiny_trainstep_matches_jax_o2():
    """The same run at amp_level O2 (bf16 working copies, f32 masters):
    the tolerances of the plain O2 test (losses rtol 5e-3, update within
    10%), scales rtol 5e-2 (the weight quanters observe bf16 weights).
    Measured, unperturbed and over four 1e-7 perturbations of the init:
    losses up to 1.6e-3, update 6.5-6.6%, scales 9.8e-3.  The quanters' buffers stay
    float32: O2 binds parameters only, as JAX's decorate casts only them."""
    jl, tl, jw, tw, init, js, ts, t = _train_both("O2")
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert tl[-1] < tl[0]
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=5e-2, err_msg=k)
    assert _update_diff(jw, tw, init) < 0.1
    assert {b.dtype for b in t.buffers()} == {torch.float32}


def test_converter_round_trips_a_wrapped_gpt():
    """load / export carry the wrapped names both ways: ``.inner.weight``
    transposed like any Linear weight, the quanters' 0-d scales as
    scalars; the keys are the JAX model's, letter for letter."""
    j, t, init = _qat_gpt_pair()
    assert set(t.state_dict()) == set(init)
    assert init["gpt.layers.0.qkv.act_quanter.scale"].shape == ()
    with torch.no_grad():
        t.gpt.layers[0].qkv.act_quanter.scale.fill_(2.5)
    out = export_paddle_tpu_state_dict(t, init)
    assert out["gpt.layers.0.qkv.act_quanter.scale"].shape == ()
    assert float(out["gpt.layers.0.qkv.act_quanter.scale"]) == 2.5
    w = "gpt.layers.1.ffn1.inner.weight"
    np.testing.assert_array_equal(out[w], init[w])
    assert tuple(t.state_dict()[w].shape) == init[w].shape[::-1]
    t2 = tquant.QAT(tquant.QuantConfig()).quantize(GPTForCausalLM(device="cpu", **GPT_CFG))
    load_paddle_tpu_state_dict(t2, out)
    for k, v in t.state_dict().items():
        assert torch.equal(t2.state_dict()[k], v), k
    bad = dict(out)
    bad.pop("gpt.layers.0.qkv.weight_quanter.scale")
    with pytest.raises(KeyError, match="weight_quanter"):
        load_paddle_tpu_state_dict(t2, bad)


# ------------------------------------------------------------------ PTQ
def test_ptq_calibrate_convert_and_int8_match_jax():
    """PTQ observe -> convert -> extract_scales equal to JAX's (Python
    floats, exactly) and the frozen model's output rtol 1e-6 (summation
    order), then convert_to_int8: the Int8Linears' int8 weights byte-equal
    and their static-scale outputs rtol 1e-6."""
    paddle.seed(2)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = torch.nn.Sequential(Linear(8, 16), torch.nn.ReLU(), Linear(16, 4))
    load_paddle_tpu_state_dict(tm, state)
    jp, tp = jquant.PTQ(), tquant.PTQ()
    jm, tm = jp.quantize(jm), tp.quantize(tm)
    rs = np.random.RandomState(3)
    for _ in range(4):
        x = rs.randn(16, 8).astype("float32")
        jm(paddle.to_tensor(x))
        tm(torch.from_numpy(x))
    js_obs, ts_obs = jquant.extract_scales(jm), tquant.extract_scales(tm)
    assert ts_obs == js_obs and len(ts_obs) == 4
    jm, tm = jp.convert(jm), tp.convert(tm)
    assert isinstance(tm[0].act_quanter, tquant._FrozenFakeQuant)
    js, ts = jquant.extract_scales(jm), tquant.extract_scales(tm)
    assert ts == js
    x = rs.randn(4, 8).astype("float32")
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=1e-6, atol=1e-6)
    jquant.convert_to_int8(jm)
    tquant.convert_to_int8(tm)
    for i in (0, 2):
        assert isinstance(tm[i], tquant.Int8Linear)
        assert tm[i].act_scale == jm[i].act_scale and tm[i].w_scale == jm[i].w_scale
        np.testing.assert_array_equal(tm[i].weight_int8.numpy().T,
                                      np.asarray(jm[i].weight_int8._value))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=1e-6, atol=1e-6)


def test_convert_to_int8_skips_uncalibrated_wrappers():
    """An observer that never saw data reports its epsilon floor: the
    wrapper keeps fake-quant numerics, as in JAX."""
    m = tquant.PTQ().quantize(torch.nn.Sequential(Linear(4, 4)))
    m = tquant.PTQ().convert(m)
    tquant.convert_to_int8(m)
    assert isinstance(m[0], tquant._QuantedWrapper)


# ------------------------------------------------- convert into serving
CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PROMPTS = [np.random.RandomState(20 + i).randint(1, 96, (n,)).tolist()
           for i, n in enumerate((3, 8, 13, 16, 40, 9))]


def _serve(eng):
    with eng:
        hs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
        return [h.result(timeout=300) for h in hs], eng.stats()


def test_convert_to_int8_serves_byte_identical_to_jax():
    """QAT GPT-tiny trained 5 steps by the JAX TrainStep, its state (the
    quanters' scales included) carried into the port, both converted by
    convert_to_int8 (8 Int8Linears with static activation scales) and
    served by the int8 engine: greedy ids byte-identical.  The engine
    converts nothing more (quantize_model_weights finds no Linear)."""
    paddle.seed(0)
    j = jquant.QAT(jquant.QuantConfig()).quantize(JGPT(**CFG))
    o = jopt.AdamW(learning_rate=1e-2, parameters=j.parameters())
    step = paddle.jit.TrainStep(j, o, loss_fn=None)
    ids = paddle.to_tensor(np.random.RandomState(0).randint(1, 96, (8, 20)).astype("int64"))
    for _ in range(5):
        step({"input_ids": ids, "labels": ids})
    j.eval()
    state = {k: np.asarray(v._value) for k, v in j.state_dict().items()}
    t = tquant.QAT(tquant.QuantConfig()).quantize(GPTForCausalLM(device="cpu", **CFG)).eval()
    load_paddle_tpu_state_dict(t, state)
    assert tquant.extract_scales(t) == jquant.extract_scales(j)
    jquant.convert_to_int8(j)
    tquant.convert_to_int8(t)
    int8 = [m for m in t.modules() if isinstance(m, tquant.Int8Linear)]
    assert len(int8) == 8 and all(m.act_scale is not None for m in int8)
    assert quantize_model_weights(t) == 0
    want, _ = _serve(JServingEngine(j, num_slots=3, page_size=8, max_model_len=64,
                                    kv_dtype="int8"))
    got, stats = _serve(ServingEngine(t, device="cpu", num_slots=3, page_size=8,
                                      max_model_len=64, kv_dtype="int8"))
    assert got == want
    assert stats["kv_dtype"] == "int8"
    got_w8, _ = _serve(ServingEngine(t, device="cpu", num_slots=3, page_size=8,
                                     max_model_len=64, kv_dtype="int8",
                                     weight_dtype="int8"))
    assert got_w8 == want
