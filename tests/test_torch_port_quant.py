"""PyTorch port, the int8 serving slice: paddle_tpu_torch's quantization
grid, quantizing pool writes, the plain versions of K4 / K5a / K5b,
Int8Linear, the int8 ServingEngine (kv_dtype / weight_dtype), its stats,
the BlockManager capacity math and the calibration harness, each against
the JAX package on the same inputs (CPU).

The JAX paged Pallas kernels cannot run on this jax (``enable_x64``
import), so the port's plain K4 is held to ``paged_attention_quantized_ref``
— what the JAX engine itself runs off the TPU.  Empty rows give zeros in
the port (as every kernel does); the JAX oracle gives the mean of V."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as opt
from paddle_tpu.ops import quant as jq
from paddle_tpu.quantization import Int8Linear as JInt8Linear
from paddle_tpu.serving import BlockManager as JBlockManager
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.quant import calibrate as jcalibrate
from paddle_tpu.serving.quant import choose_scale as jchoose_scale
from paddle_tpu.serving.quant import quantize_model_weights as jquantize_weights
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.nn.layers.common import Linear
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import quant as tq
from paddle_tpu_torch.quantization import Int8Linear
from paddle_tpu_torch.serving import BlockManager, ServingEngine
from paddle_tpu_torch.serving.quant import (QuantizedGPTAdapter, calibrate,
                                            choose_scale, quantize_model_weights,
                                            top1_agreement)
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8
MAXLEN = 64
PROMPT_LENS = (3, 8, 13, 16, 40, 9)
NEW = 10


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


PROMPTS = [_prompt(n, 20 + i) for i, n in enumerate(PROMPT_LENS)]


def tiny_jax_gpt(train_steps=5, seed=0):
    """Tiny GPT, briefly trained so greedy decode emits varied tokens."""
    paddle.seed(seed)
    m = JGPT(**CFG)
    o = opt.AdamW(learning_rate=1e-2, parameters=m.parameters())
    step = paddle.jit.TrainStep(m, o, loss_fn=None)
    ids = paddle.to_tensor(
        np.random.RandomState(0).randint(1, 96, (8, 20)).astype("int64"))
    for _ in range(train_steps):
        step({"input_ids": ids, "labels": ids})
    return m.eval()


def jax_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_model():
    return tiny_jax_gpt()


@pytest.fixture(scope="module")
def state(jax_model):
    return jax_state(jax_model)


def port_model(state):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(m, state)
    return m.eval()


def _jax_ids(model, **kw):
    with JServingEngine(model, num_slots=3, page_size=PS,
                        max_model_len=MAXLEN, **kw) as eng:
        hs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        return [h.result(timeout=300) for h in hs], eng.stats()


def _port_ids(model, **kw):
    with ServingEngine(model, device="cpu", num_slots=3, page_size=PS,
                       max_model_len=MAXLEN, **kw) as eng:
        hs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        return [h.result(timeout=300) for h in hs], eng.stats(), eng


@pytest.fixture(scope="module")
def jax_w8():
    """A second copy of the tiny JAX GPT with its Linears converted to
    Int8Linear (JAX layers do not deep-copy), and the count converted."""
    m = tiny_jax_gpt()
    return m, jquantize_weights(m)


@pytest.fixture(scope="module")
def jax_int8_run(jax_model):
    return _jax_ids(jax_model, kv_dtype="int8")


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x)
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# ------------------------------------------------------------------ grid
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_byte_equal_to_jax(dtype):
    """absmax scales, int8 rounding (ties to even, clipped) and dequant:
    equal bytes, per tensor and per row, with exact .5 ties present."""
    rs = np.random.RandomState(1)
    x = (rs.randn(6, 4, 16) * 3).astype("float32")
    x[0, 0, :4] = [127.0, -63.5, 0.5, -1.5]        # ties on the grid of 1.0
    x[1, 1] = 0.0                                   # an all-zero row
    jx, tx = _both(x, dtype)
    for axis in (None, -1):
        jqv, js = jq.quantize_absmax(jx, axis=axis)
        tqv, ts = tq.quantize_absmax(tx, axis=axis)
        assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tq.dequantize(tqv, ts).numpy(), np.asarray(jq.dequantize(jqv, js)))
    np.testing.assert_array_equal(
        tq.quantize(tx, 0.37).numpy(),
        np.asarray(jq.quantize(jx, jnp.float32(0.37))))
    assert tq.qmax_for(4) == jq.qmax_for(4) == 7.0


def test_choose_scale_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(4096).astype("float32")
    x[::512] *= 40.0
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(choose_scale(tx).numpy(),
                                  np.asarray(jchoose_scale(jx)))
    np.testing.assert_allclose(
        choose_scale(tx, method="percentile", pct=99.5).numpy(),
        np.asarray(jchoose_scale(jx, method="percentile", pct=99.5)),
        rtol=1e-6)
    with pytest.raises(ValueError):
        choose_scale(tx, method="median")


# ----------------------------------------------------------- pool writes
def test_quant_pool_writes_byte_equal_to_jax():
    """Prefill and token writes give the JAX package's int8 payload and
    float32 scale pools, byte for byte, over the same table."""
    rs = np.random.RandomState(3)
    B, S, h, d, ps, P = 3, 13, 2, 16, 4, 20
    kv = rs.randn(B, S, h, d).astype("float32")
    tok = rs.randn(B, h, d).astype("float32")
    table = rs.permutation(P)[:B * 5].reshape(B, 5).astype("int32")
    lens = np.asarray([13, 16, 0], "int32")
    jpool, jsp = jnp.zeros((P, ps, h, d), jnp.int8), jnp.zeros((P, ps, h))
    jpool, jsp = jpa.paged_table_prefill_write_quant(
        jpool, jsp.astype(jnp.float32), jnp.asarray(kv), jnp.asarray(table))
    jpool, jsp = jpa.paged_table_token_write_quant(
        jpool, jsp, jnp.asarray(tok), jnp.asarray(table), jnp.asarray(lens))
    tpool = torch.zeros((P, ps, h, d), dtype=torch.int8)
    tsp = torch.zeros((P, ps, h), dtype=torch.float32)
    out = tpa.paged_table_prefill_write_quant(
        tpool, tsp, torch.from_numpy(kv), torch.from_numpy(table))
    assert out[0] is tpool and out[1] is tsp              # in place
    tpa.paged_table_token_write_quant(tpool, tsp, torch.from_numpy(tok),
                                      torch.from_numpy(table),
                                      torch.from_numpy(lens))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))


# ------------------------------------------------------- K4 / K5 (plain)
def _quant_inputs(seed, lens, h, hkv, ps=8, np_=4, d=16, extra=3):
    B = len(lens)
    P = B * np_ + extra
    rs = np.random.RandomState(seed)
    q = rs.randn(B, h, d).astype("float32")
    kq, ks = jpa.quantize_kv(jnp.asarray(rs.randn(P, ps, hkv, d)
                                         .astype("float32")))
    vq, vs = jpa.quantize_kv(jnp.asarray(rs.randn(P, ps, hkv, d)
                                         .astype("float32")))
    table = rs.permutation(P)[:B * np_].reshape(B, np_).astype("int32")
    return [q] + [np.array(a) for a in (kq, vq, ks, vs)] + \
        [table, np.asarray(lens, "int32")]


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)])
def test_quantized_attention_matches_jax_oracle(h, hkv):
    """Plain K4 vs paged_attention_quantized_ref, atol 1e-5, ragged and
    past-table lengths over shuffled pages; empty rows are zeros."""
    ps, np_ = 8, 4
    lens = [1, ps - 1, ps, ps + 1, np_ * ps, 0, 2 * ps + 3, np_ * ps + 5]
    args = _quant_inputs(30 + h + hkv, lens, h, hkv, ps, np_)
    jargs = [jnp.asarray(a) for a in args]
    jargs[-1] = jnp.minimum(jargs[-1], np_ * ps)
    want = np.asarray(jpa.paged_attention_quantized_ref(*jargs))
    targs = [torch.from_numpy(a) for a in args]
    got = tpa.paged_attention_quantized(*targs).numpy()
    live = args[-1] > 0
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=0)
    assert np.all(got[~live] == 0.0)
    np.testing.assert_array_equal(
        tpa.paged_attention_quantized_ref(*targs).numpy(), got)


def test_full_sweep_plain_paths():
    """K5a / K5b take the plain versions of K3 / K4 on the CPU: the same
    function, so the same output (and JAX's oracles on live rows)."""
    lens = [5, 0, 17, 32]
    args = _quant_inputs(7, lens, 4, 2)
    t = [torch.from_numpy(a) for a in args]
    q, kq, vq, ks, vs, table, ln = t
    got_q = tpa._paged_q_full_sweep(q, kq, vq, ks, vs, table, ln)
    assert torch.equal(got_q, tpa.paged_attention_quantized(*t))
    kf, vf = kq.float() * ks[..., None], vq.float() * vs[..., None]
    got = tpa._paged_full_sweep(q, kf, vf, table, ln)
    assert torch.equal(got, tpa.paged_attention(q, kf, vf, table, ln))
    want = np.asarray(jpa.paged_attention_ref(*(jnp.asarray(x.numpy())
                                                for x in (q, kf, vf, table, ln))))
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-5)
    torch.testing.assert_close(got_q, got, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tpa._paged_q_full_sweep(q[:, :3], kq, vq, ks, vs, table, ln)


def test_kernels_refuse_tensors_off_the_card():
    """On a device that is neither the CPU nor the card, the int8 and
    full-sweep entries raise instead of running anything."""
    qd = torch.empty(2, 2, 16, device="meta")
    pool = torch.empty(4, 8, 2, 16, dtype=torch.int8, device="meta")
    sc = torch.empty(4, 8, 2, device="meta")
    table = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    ln = torch.zeros(2, dtype=torch.int32, device="meta")
    n = (tpa.QUANT_LAUNCHES, tpa.FULL_SWEEP_LAUNCHES,
         tpa.QUANT_FULL_SWEEP_LAUNCHES)
    with pytest.raises(NotImplementedError):
        tpa.paged_attention_quantized(qd, pool, pool, sc, sc, table, ln)
    with pytest.raises(NotImplementedError):
        tpa._paged_q_full_sweep(qd, pool, pool, sc, sc, table, ln)
    with pytest.raises(NotImplementedError):
        tpa._paged_full_sweep(qd, sc[..., None].expand(4, 8, 2, 16), sc,
                              table, ln)
    assert n == (tpa.QUANT_LAUNCHES, tpa.FULL_SWEEP_LAUNCHES,
                 tpa.QUANT_FULL_SWEEP_LAUNCHES)


# ------------------------------------------------------------ Int8Linear
@pytest.mark.parametrize("bias,act_scale,dtype", [
    (True, None, "float32"), (False, None, "float32"), (True, 0.05, "float32"),
    (True, None, "bfloat16")])
def test_int8_linear_matches_jax(bias, act_scale, dtype):
    """weight_int8 byte-equal ([in, out] in JAX, [out, in] here) and the
    outputs within rtol 1e-6, with the dynamic per-tensor activation scale
    and a static one; 5 rows, so the padding for torch._int_mm runs."""
    paddle.seed(4)
    jl = jnn.Linear(24, 40, bias_attr=None if bias else False)
    w = np.asarray(jl.weight._value)                  # [in, out]
    tl = Linear(24, 40, bias=bias)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            b = np.random.RandomState(5).randn(40).astype("float32")
            jl.bias._value = jnp.asarray(b)
            tl.bias.copy_(torch.from_numpy(b))
    s = float(np.abs(w).max()) / 127
    ji, ti = JInt8Linear(jl, s, act_scale), Int8Linear(tl, s, act_scale)
    np.testing.assert_array_equal(ti.weight_int8.numpy().T,
                                  np.asarray(ji.weight_int8._value))
    x = np.random.RandomState(6).randn(5, 24).astype("float32")
    jx, tx = _both(x, dtype)
    want = np.asarray(ji(paddle.Tensor(jx))._value.astype(jnp.float32))
    with torch.no_grad():
        got = ti(tx)
    assert got.dtype == tx.dtype and got.shape == (5, 40)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6 if dtype == "float32" else 0)
    # a 3-D input takes one scale over every row, as in JAX
    x3 = np.random.RandomState(7).randn(2, 3, 24).astype("float32")
    want3 = np.asarray(ji(paddle.to_tensor(x3))._value)
    with torch.no_grad():
        got3 = ti(torch.from_numpy(x3))
    np.testing.assert_allclose(got3.numpy(), want3, rtol=1e-6, atol=1e-6)


def test_quantize_model_weights_and_state_dict_match_jax(jax_w8, state):
    """Both models converted with their own quantize_model_weights: equal
    w_scale floats, weight_int8 byte-equal through the converter in both
    directions, and a second call converts nothing (idempotent)."""
    jm, n_converted = jax_w8
    tm = port_model(state)
    assert quantize_model_weights(tm) == n_converted == 8
    assert quantize_model_weights(tm) == jquantize_weights(jm) == 0
    jmods = dict(jm.named_sublayers())
    for name, m in tm.named_modules():
        if isinstance(m, Int8Linear):
            assert m.w_scale == jmods[name].w_scale
    jconv = jax_state(jm)
    out = export_paddle_tpu_state_dict(tm, expected=jconv)
    for k, v in jconv.items():
        if k.endswith("weight_int8"):
            assert out[k].dtype == np.int8
            np.testing.assert_array_equal(out[k], v)
    tm2 = port_model(state)
    quantize_model_weights(tm2)
    load_paddle_tpu_state_dict(tm2, jconv)
    for (k, a), b in zip(tm.state_dict().items(), tm2.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- engine
def test_int8_engine_greedy_byte_identical_to_jax(state, jax_int8_run):
    """ServingEngine(kv_dtype="int8") on the CPU: the JAX int8 engine's
    greedy ids, byte for byte, and its stats surface."""
    want, jst = jax_int8_run
    got, st, eng = _port_ids(port_model(state), kv_dtype="int8")
    assert got == want
    assert len({tuple(t) for t in got}) > 1
    kp, vp, ks, vs = eng._pools
    assert kp.dtype == vp.dtype == torch.int8
    assert ks.dtype == vs.dtype == torch.float32 and ks.shape == kp.shape[:-1]
    assert isinstance(eng._adapter, QuantizedGPTAdapter)
    for key in ("kv_dtype", "weight_dtype", "pool_dtype", "bytes_per_page",
                "kv_bytes_per_token", "num_pages", "iteration"):
        assert st[key] == jst[key], key
    assert st["prefills"] == len(PROMPTS)
    assert eng.block_manager.free_pages == eng.block_manager.num_pages


def test_int8_kv_and_weights_engine_byte_identical_to_jax(jax_w8, state):
    """weight_dtype="int8" as well: the dynamic activation absmax couples
    the rows of every call (prompt pads, inactive decode lanes), so the
    ids match only if those rows match too."""
    want, jst = _jax_ids(jax_w8[0], kv_dtype="int8", weight_dtype="int8")
    tm = port_model(state)
    got, st, _ = _port_ids(tm, kv_dtype="int8", weight_dtype="int8")
    assert got == want
    assert sum(isinstance(m, Int8Linear) for m in tm.modules()) == 8
    assert st["weight_dtype"] == jst["weight_dtype"] == "int8"


def test_native_engine_stats_match_jax(jax_model, state):
    """The default engine reports the native pool dtype as the JAX engine
    spells it ("float32", not "torch.float32")."""
    eng = ServingEngine(port_model(state), device="cpu", page_size=PS,
                        max_model_len=MAXLEN, kv_dtype="bf16")
    jeng = JServingEngine(jax_model, page_size=PS, max_model_len=MAXLEN)
    st, jst = eng.stats(), jeng.stats()
    for key in ("kv_dtype", "weight_dtype", "pool_dtype", "bytes_per_page",
                "kv_bytes_per_token"):
        assert st[key] == jst[key], key
    assert st["pool_dtype"] == "float32" and st["kv_dtype"] == "native"
    bm, jbm = eng.block_manager.stats(), jeng.block_manager.stats()
    for key in ("pool_dtype", "pool_bytes", "used_bytes", "kv_bytes_per_token"):
        assert bm[key] == jbm[key], key


@pytest.mark.parametrize("kw", [dict(kv_dtype="int4"), dict(kv_dtype="fp8"),
                                dict(weight_dtype="int4"),
                                dict(weight_dtype="bf16")])
def test_bad_dtypes_raise(state, kw):
    with pytest.raises(ValueError):
        ServingEngine(port_model(state), device="cpu", page_size=PS,
                      max_model_len=MAXLEN, **kw)


def test_resident_sequences_1_8x_at_d64():
    """At one pool budget, int8 pages (d + 4 bytes per position per head)
    hold >= 1.8x the resident sequences of bf16 pages (2 d bytes), and the
    capacity math and byte stats equal the JAX BlockManager's."""
    torch.manual_seed(5)
    m = GPTForCausalLM(device="cpu", vocab_size=64, hidden_size=128,
                       num_hidden_layers=1, num_attention_heads=2,
                       max_position_embeddings=64)
    ad = QuantizedGPTAdapter(m, page_size=16)
    assert ad.head_dim == 64
    L, ps, h, d = ad.num_layers, ad.page_size, ad.num_kv_heads, ad.head_dim
    bf16_bpp = 2 * L * ps * h * d * 2
    assert ad.page_bytes() == 2 * L * ps * h * (d + 4)
    tokens, budget = 48 + 80, 64 * bf16_bpp
    r = {}
    for dt, bpp in (("bfloat16", bf16_bpp), ("int8", ad.page_bytes())):
        bm = BlockManager(64, 16, bytes_per_page=bpp, pool_dtype=dt)
        jbm = JBlockManager(64, 16, bytes_per_page=bpp, pool_dtype=dt)
        r[dt] = bm.max_resident_sequences(tokens, budget_bytes=budget)
        assert r[dt] == jbm.max_resident_sequences(tokens, budget_bytes=budget)
        assert bm.max_resident_sequences(tokens) == \
            jbm.max_resident_sequences(tokens)
        a, ja = bm.allocate([1, 2, 3], 40), jbm.allocate([1, 2, 3], 40)
        for key in ("pool_dtype", "pool_bytes", "used_bytes",
                    "kv_bytes_per_token", "bytes_per_page"):
            assert bm.stats()[key] == jbm.stats()[key], key
        bm.free(a)
        jbm.free(ja)
    assert r["int8"] >= 1.8 * r["bfloat16"], r
    with pytest.raises(ValueError):
        BlockManager(4, 4).max_resident_sequences(4, budget_bytes=1 << 20)


# ----------------------------------------------------------- calibration
def _jax_causal_kv_error(jax_model, prompts):
    """The JAX harness's per-layer K/V round-trip error, taken from the qkv
    projections of the JAX model's causal no-cache forward."""
    gpt = jax_model.gpt
    hd = gpt.layers[0].head_dim
    seen = {}
    hooks = [blk.qkv.register_forward_post_hook(
        lambda layer, args, out, i=i: seen.__setitem__(i, out._value))
        for i, blk in enumerate(gpt.layers)]
    err = np.zeros(len(gpt.layers))
    ref = np.zeros(len(gpt.layers))
    try:
        for p in prompts:
            gpt(paddle.to_tensor(np.asarray([p], "int64")))
            for i, qkv in seen.items():
                qkv = qkv.reshape(qkv.shape[0], qkv.shape[1], -1, 3, hd)
                for t in (qkv[:, :, :, 1], qkv[:, :, :, 2]):
                    t = t.astype(jnp.float32)
                    qv, sc = jq.quantize_absmax(t, axis=-1)
                    d = jq.dequantize(qv, sc) - t
                    err[i] += float(jnp.sum(d * d))
                    ref[i] += float(jnp.sum(t * t))
    finally:
        for h in hooks:
            h.remove()
    return np.sqrt(err / np.maximum(ref, 1e-12))


def test_calibrate_report_matches_jax(jax_model, state):
    """The harness on both packages: per-layer KV and weight errors within
    1e-5, the same greedy streams and agreement, the same occupancy."""
    prompts = PROMPTS[:3]
    kw = dict(max_new_tokens=8, page_size=PS, num_slots=3)
    want = jcalibrate(jax_model, prompts, **kw)
    got = calibrate(port_model(state), prompts,
                    engine_kwargs={"device": "cpu"}, **kw)
    # layer 0 sees the same K/V in both; JAX reads later layers through its
    # concat-cache variant, which attends the prompt non-causally, so they
    # are held to the causal K/V of the JAX model's own no-cache forward
    kv_err = got["per_layer_kv_error"]
    assert abs(kv_err[0] - want["per_layer_kv_error"][0]) <= 1e-5
    np.testing.assert_allclose(kv_err, _jax_causal_kv_error(jax_model, prompts),
                               atol=1e-5, rtol=0)
    assert got["per_layer_weight_error"].keys() == \
        want["per_layer_weight_error"].keys()
    np.testing.assert_allclose(list(got["per_layer_weight_error"].values()),
                               list(want["per_layer_weight_error"].values()),
                               atol=1e-5, rtol=0)
    assert got["reference_ids"] == want["reference_ids"]
    assert got["quantized_ids"] == want["quantized_ids"]
    assert got["top1_agreement"] == want["top1_agreement"]
    assert got["top1_agreement"] == top1_agreement(got["reference_ids"],
                                                   got["quantized_ids"])
    assert got["kv_bytes_per_token"] == want["kv_bytes_per_token"]
    assert got["occupancy_ratio"] == want["occupancy_ratio"]
    assert got["weights_converted"] == 0 and got["weight_scales"] is None
    assert got["quantized_stats"]["kv_dtype"] == "int8"
