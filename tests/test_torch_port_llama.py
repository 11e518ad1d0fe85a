"""PyTorch port, the Llama family, held against the JAX package on the CPU
with the same numpy inputs and the same weights (the JAX model's, carried
across by ``load_paddle_tpu_state_dict``).

- ``rms_norm`` / ``RMSNorm`` / ``silu`` within 1e-6.
- f32 logits of the no-cache forward within 1e-5 for MHA, GQA (4 / 2) and
  MQA (4 / 1), tied and untied heads, plain, with an ``attention_mask`` and
  with batched ``position_ids``; the ``labels`` loss within 1e-5.
- Greedy ``generate`` ids byte-identical to JAX's for the dense cache, the
  paged cache (page 4), ``use_cache=False`` and beam search, MHA and GQA;
  paged equal to dense over prompt lengths around a page boundary.
- bf16 weights: hidden states and logits come out f32, as JAX's do (jnp
  promotion: the f32 rope tables lift q / k, the attention output lifts the
  residual stream), within 2e-3 of JAX's ``.bfloat16()`` model, and the
  greedy ids of every ``generate`` path equal JAX's.
- The dtype promotion of ``Linear`` and ``scaled_dot_product_attention``:
  mixed inputs against jnp, and GPT's logits (f32 and bf16) bit for bit
  those of the same model with the promotion taken out.
- ``TrainStep`` (AdamW, global-norm clip) 5 steps from one converted init,
  f32 and AMP O1 / O2: losses rtol 1e-4 and final weights atol 1e-4 (f32);
  eager ``loss.backward()`` gradients within 1e-5.
- The paged decode's plain version with an f32 q over bf16 pools against
  the JAX oracle."""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.text.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import Linear, RMSNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.text.models import (GPTForCausalLM, LlamaConfig,
                                          LlamaForCausalLM,
                                          export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from paddle_tpu_torch.text.models import convert
from paddle_tpu_torch.text.models import llama as tllama
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(vocab_size=160, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=128)
# (kv heads, tied head): MHA, GQA 4 / 2, MQA 4 / 1
CONFIGS = {"mha": (4, False), "gqa": (2, False), "mqa": (1, True),
           "gqa_tied": (2, True)}


def _cfg(name):
    kv, tie = CONFIGS[name]
    return dict(BASE, num_key_value_heads=kv, tie_word_embeddings=tie)


def _state(m):
    return {k: np.asarray(v._value) for k, v in m.state_dict().items()}


def _pair(name, seed=1):
    """The JAX model (eval) and the port's with its weights."""
    paddle.seed(seed)
    j = JLlama(**_cfg(name))
    j.eval()
    t = LlamaForCausalLM(device="cpu", **_cfg(name))
    load_paddle_tpu_state_dict(t, _state(j))
    return j, t.eval()


_PAIRS = {}


def _shared(name):
    """The pair of config ``name``, built once per process."""
    if name not in _PAIRS:
        _PAIRS[name] = _pair(name)
    return _PAIRS[name]


@pytest.fixture(params=list(CONFIGS))
def pair(request):
    return _shared(request.param)


def _ids(seed, b, s, vocab=160):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype("int64")


def _np(x):
    return x.detach().float().numpy()


# --------------------------------------------------------------- functionals
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 8)])
def test_rms_norm_rmsnorm_and_silu_match_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype("float32") * 3
    w = np.random.RandomState(1).randn(shape[-1]).astype("float32")
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        _np(TF.rms_norm(tx, torch.from_numpy(w), 1e-5)),
        JF.rms_norm(jx, paddle.to_tensor(w), 1e-5).numpy(), rtol=1e-6, atol=1e-6)
    jn, tn = jnn.RMSNorm(shape[-1], epsilon=1e-6), RMSNorm(shape[-1], 1e-6)
    assert bool((tn.weight == 1).all())
    np.testing.assert_allclose(_np(tn(tx)), jn(jx).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(TF.silu(tx)), JF.silu(jx).numpy(),
                               rtol=1e-6, atol=1e-6)
    # a bf16 weight times an f32 x promotes to f32, as in jnp
    wb = torch.from_numpy(w).bfloat16()
    assert TF.rms_norm(tx, wb).dtype == torch.float32


# ------------------------------------------------------------------- logits
def test_state_dict_keys_are_the_jax_models():
    for name, tied in (("gqa_tied", True), ("gqa", False)):
        j, _ = _shared(name)
        t = LlamaForCausalLM(device="cpu", **_cfg(name))
        assert set(t.state_dict()) == set(_state(j))
        assert ("lm_head.weight" in t.state_dict()) is not tied


@pytest.mark.parametrize("inputs", ["plain", "attention_mask", "position_ids"])
def test_logits_match_jax(pair, inputs):
    """f32 no-cache logits within 1e-5; a right-padded row under its mask,
    and per-row position ids (the second row spaced by 2)."""
    j, t = pair
    ids = _ids(0, 2, 10)
    kw_j, kw_t = {}, {}
    if inputs == "attention_mask":
        mask = np.ones((2, 10), "int64")
        mask[1, 6:] = 0
        kw_j["attention_mask"] = paddle.to_tensor(mask)
        kw_t["attention_mask"] = torch.from_numpy(mask)
    elif inputs == "position_ids":
        pos = np.stack([np.arange(10), np.arange(10) * 2]).astype("int64")
        kw_j["position_ids"] = paddle.to_tensor(pos)
        kw_t["position_ids"] = torch.from_numpy(pos)
    want = j(paddle.to_tensor(ids), **kw_j).numpy()
    with torch.no_grad():
        got = t(torch.from_numpy(ids), **kw_t)
    assert got.dtype == torch.float32 and got.shape == (2, 10, 160)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_labels_loss_matches_jax(pair):
    j, t = pair
    ids = _ids(3, 3, 12)
    want = float(j(paddle.to_tensor(ids), labels=paddle.to_tensor(ids)))
    got = t(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert got.ndim == 0
    assert float(got.detach()) == pytest.approx(want, rel=1e-5, abs=1e-5)


# ----------------------------------------------------------------- generate
GEN_CASES = {
    "dense": dict(max_new_tokens=12),
    "paged": dict(max_new_tokens=12, cache_impl="paged", page_size=4),
    "no_cache": dict(max_new_tokens=4, use_cache=False),
    "beam": dict(max_new_tokens=5, decode_strategy="beam_search",
                 num_beams=3),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_generate_ids_match_jax(name, case):
    j, t = _shared(name)
    ids = _ids(7, 2, 9)
    kw = dict(GEN_CASES[case], temperature=0.0)
    want = j.generate(paddle.to_tensor(ids), **kw).numpy()
    got = t.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s0", [3, 4, 5, 8])
def test_paged_equals_dense(s0):
    """The grouped paged decode (pools at hkv heads) gives the dense
    repeated-KV decode's ids, below, at and past a page boundary."""
    _, t = _shared("gqa")
    ids = torch.from_numpy(_ids(s0, 2, s0))
    dense = t.generate(ids, max_new_tokens=16, temperature=0.0)
    paged = t.generate(ids, max_new_tokens=16, temperature=0.0,
                       cache_impl="paged", page_size=4)
    assert torch.equal(dense, paged)


def test_dense_cache_with_key_padding_matches_jax():
    """The dense cache under a key-slot mask ``[B, T]`` (a right-padded
    prefill into an 8-slot cache): hidden states and the written
    (rotated) keys within 1e-5 of JAX's; a mask short of the T slots
    raises as in JAX."""
    j, t = _shared("gqa")
    padded = np.concatenate([_ids(9, 2, 5), np.zeros((2, 3), "int64")], 1)
    padded[1, 4] = 0
    kmask = (padded != 0).astype("int64")
    L, shape = BASE["num_hidden_layers"], (2, 8, 2, 16)      # T = 8 slots
    jc = [(paddle.to_tensor(np.zeros(shape, "float32")),
           paddle.to_tensor(np.zeros(shape, "float32")),
           paddle.to_tensor(np.int32(0))) for _ in range(L)]
    tc = [(torch.zeros(shape), torch.zeros(shape), 0) for _ in range(L)]
    jh, jnew = j.llama(paddle.to_tensor(padded),
                       attention_mask=paddle.to_tensor(kmask), cache=jc)
    with torch.no_grad():
        th, tnew = t.llama(torch.from_numpy(padded),
                           attention_mask=torch.from_numpy(kmask), cache=tc)
    np.testing.assert_allclose(_np(th), jh.numpy(), **TOL)
    for (jk, jv, _), (tk, tv, _) in zip(jnew, tnew):
        np.testing.assert_allclose(_np(tk), jk.numpy(), **TOL)
        np.testing.assert_allclose(_np(tv), jv.numpy(), **TOL)
    with pytest.raises(ValueError, match="cache slots"):
        t.llama(torch.from_numpy(padded),
                attention_mask=torch.ones(2, 3, dtype=torch.int64),
                cache=[(torch.zeros(shape), torch.zeros(shape), 0)] * L)


def test_generate_rejects_what_jax_rejects():
    _, t = _shared("gqa")
    ids = torch.from_numpy(_ids(0, 1, 100))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        t.generate(ids, max_new_tokens=40, temperature=0.0)
    with pytest.raises(ValueError, match="cache_impl"):
        t.generate(ids[:, :4], max_new_tokens=2, cache_impl="ring")
    with pytest.raises(NotImplementedError, match="paged cache"):
        pool = torch.zeros(1, 1, 4, 2, 16)
        t.llama(ids[:, :4], attention_mask=torch.ones(1, 4, dtype=torch.int64),
                cache=[("paged", pool, pool.clone(), 0)] * 2)


# --------------------------------------------------------------- bf16 weights
@pytest.fixture(scope="module")
def bf16_pair():
    j, t = _pair("gqa", seed=3)
    return j.bfloat16(), t.to(torch.bfloat16)


def test_bf16_weights_compute_in_f32_like_jax(bf16_pair):
    """JAX's bf16 Llama returns f32 hidden states and logits (jnp promotion
    of the f32 rope tables); the port's does too, within 2e-3 of JAX's
    (both round the same bf16 weights; the f32 paths differ in their
    summation order only)."""
    j, t = bf16_pair
    ids = _ids(11, 2, 10)
    jh = j.llama(paddle.to_tensor(ids))
    jl = j(paddle.to_tensor(ids))
    with torch.no_grad():
        th = t.llama(torch.from_numpy(ids))
        tl = t(torch.from_numpy(ids))
    assert str(jh.numpy().dtype) == "float32" and th.dtype == torch.float32
    assert str(jl.numpy().dtype) == "float32" and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(th), jh.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(tl), jl.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_bf16_generate_ids_match_jax(bf16_pair, case):
    j, t = bf16_pair
    ids = _ids(13, 2, 9)
    kw = dict(GEN_CASES[case], temperature=0.0)
    want = j.generate(paddle.to_tensor(ids), **kw).numpy()
    np.testing.assert_array_equal(t.generate(torch.from_numpy(ids), **kw)
                                  .numpy(), want)


# ---------------------------------------------------------- dtype promotion
def test_linear_and_attention_promote_like_jnp():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 16).astype("float32")
    w = rs.randn(8, 16).astype("float32")
    lin = Linear(16, 8, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    lin = lin.bfloat16()
    got = lin(torch.from_numpy(x))
    wb = jnp.asarray(w.T).astype(jnp.bfloat16)
    want = JF.linear(paddle.to_tensor(x), paddle.Tensor(wb)).numpy()
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(_np(got), want, **TOL)
    q, k, v = (rs.randn(2, 7, 4, 16).astype("float32") for _ in range(3))
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.Tensor(vb),
        is_causal=True, training=False).numpy()
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k),
        torch.from_numpy(v).bfloat16(), is_causal=True, training=False)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt_logits_unchanged_by_the_promotion(monkeypatch, dtype):
    """GPT never mixes dtypes: its logits are bit for bit those of the same
    model with the promotion taken out of Linear and attention."""
    paddle.seed(0)
    j = JGPT(vocab_size=96, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=64)
    t = GPTForCausalLM(device="cpu", vocab_size=96, hidden_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       max_position_embeddings=64)
    load_paddle_tpu_state_dict(t, _state(j))
    t = t.to(dtype).eval()
    ids = torch.from_numpy(_ids(2, 2, 12, vocab=96))
    with torch.no_grad():
        with_promotion = t(ids)
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(with_promotion),
                                       j(paddle.to_tensor(ids.numpy())).numpy(),
                                       **TOL)
        monkeypatch.setattr("paddle_tpu_torch.nn.layers.common.promote",
                            lambda *ts: ts)
        monkeypatch.setattr(tattn, "promote", lambda *ts: ts)
        assert torch.equal(t(ids), with_promotion)


# ------------------------------------------------------------------ training
LR, STEPS = 1e-3, 5


def _train_both(amp_level):
    j, t = _pair("gqa", seed=5)
    j.train()
    t.train()
    init = _state(j)
    jo = jopt.AdamW(learning_rate=LR, parameters=j.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(learning_rate=LR, parameters=t.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(j, jo, loss_fn=None, amp_level=amp_level)
    ts = tjit.TrainStep(t, to, loss_fn=None, amp_level=amp_level)
    ids = _ids(6, 2, 16)
    jl = [float(js({"input_ids": paddle.to_tensor(ids),
                    "labels": paddle.to_tensor(ids)})) for _ in range(STEPS)]
    tl = [float(ts({"input_ids": torch.from_numpy(ids),
                    "labels": torch.from_numpy(ids)})) for _ in range(STEPS)]
    jw = {k: np.asarray(v._value, dtype=np.float32)
          for k, v in j.state_dict().items()}
    return (np.asarray(jl), np.asarray(tl), jw,
            export_paddle_tpu_state_dict(t, jw), init)


@pytest.mark.parametrize("level", [None, "O1", "O2"])
def test_trainstep_matches_jax(level):
    """5 TrainSteps (AdamW lr 1e-3, ClipGradByGlobalNorm(1.0)) of the GQA
    model from one converted init, f32 and AMP O1 / O2 (bf16): the losses
    rtol 1e-4; in f32 the final weights atol 1e-4 too."""
    jl, tl, jw, tw, init = _train_both(level)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    if level is None:
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], atol=1e-4, err_msg=k)


def test_eager_backward_gradients_match_jax():
    """``loss.backward()`` eagerly: every parameter's gradient within 1e-5
    of the JAX model's (the K / V repeat's backward sums each group)."""
    j, t = _pair("gqa", seed=7)
    ids = _ids(8, 2, 8)
    j.train()
    t.train()
    j(paddle.to_tensor(ids), labels=paddle.to_tensor(ids)).backward()
    t(torch.from_numpy(ids), labels=torch.from_numpy(ids)).backward()
    tg = {k: _np(p.grad) for k, p in t.named_parameters()}
    linear = convert._linear_weights(t)         # [out, in] here, [in, out] there
    for k, p in j.named_parameters():
        got = tg[k].T if k in linear else tg[k]
        np.testing.assert_allclose(got, np.asarray(p.grad.numpy()), **TOL,
                                   err_msg=k)


def test_gqa_repeat_backward_sums_the_group():
    """The backward of the K / V repeat sums each group's gradient, as
    jax.grad of jnp.repeat does."""
    t = torch.randn(2, 3, 2, 4, requires_grad=True)
    g = torch.randn(2, 3, 6, 4)
    (tllama._gqa_repeat(t, 3) * g).sum().backward()
    torch.testing.assert_close(t.grad, g.reshape(2, 3, 2, 3, 4).sum(3))


# ------------------------------------------------------------ paged decode
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4), (4, 1)])
def test_gathered_attend_f32_q_over_16bit_pools(pool_dtype, h, hkv):
    """``paged_decode_attend``'s plain version with an f32 q over bf16 /
    f16 pools (a bf16 Llama's decode) against the JAX oracle: f32 out,
    within 1e-5."""
    rs = np.random.RandomState(h + hkv)
    B, PP, ps, d, pos = 2, 3, 4, 16, 9
    q = rs.randn(B, h, d).astype("float32")
    kp, vp = (rs.randn(B, PP, ps, hkv, d).astype("float32") for _ in range(2))
    jdt = jnp.bfloat16 if pool_dtype == torch.bfloat16 else jnp.float16
    want = np.asarray(jpa.paged_decode_attend(
        jnp.asarray(q), jnp.asarray(kp).astype(jdt),
        jnp.asarray(vp).astype(jdt), pos))
    got = tpa.paged_decode_attend(torch.from_numpy(q),
                                  torch.from_numpy(kp).to(pool_dtype),
                                  torch.from_numpy(vp).to(pool_dtype), pos)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_config_defaults_are_the_reference_ones():
    cfg = LlamaConfig()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_key_value_heads,
            cfg.vocab_size, cfg.rope_theta) == (4096, 32, 32, 32000, 10000.0)
    assert LlamaConfig(num_attention_heads=8).num_key_value_heads == 8
    # a copied model keeps its config's attribute access
    t = LlamaForCausalLM(device="cpu", **_cfg("mqa"))
    assert copy.deepcopy(t).llama.config.num_key_value_heads == 1
