"""PyTorch port, GPT model: a tiny GPT briefly trained in JAX (so greedy
tokens vary), converted into paddle_tpu_torch with
``load_paddle_tpu_state_dict``, must give the JAX model's no-cache logits
(atol 1e-4) and the JAX GPTAdapter's prefill + decode-step logits (atol
1e-4) and pools (atol 1e-5).  Also the batched sampler: top-k/top-p masks
equal JAX's, greedy rows exact, temperature rows' frequencies within a
stated bound of softmax(filtered logits / T)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.serving import GPTAdapter as JGPTAdapter
from paddle_tpu.text.models import _decode as jdecode
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.serving import GPTAdapter
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from paddle_tpu_torch.text.models import _decode
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8


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


def jax_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def port_of(jmodel, dtype=torch.float32):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(m, jax_state(jmodel))
    return m.to(dtype).eval()


@pytest.fixture(scope="module")
def models():
    j = tiny_jax_gpt()
    return j, port_of(j)


def test_convert_checks_keys_and_shapes(models):
    j, _ = models
    state = jax_state(j)
    m = GPTForCausalLM(device="cpu", **CFG)
    with pytest.raises(KeyError, match="missing"):
        load_paddle_tpu_state_dict(m, {k: v for k, v in state.items()
                                       if k != "gpt.final_ln.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_paddle_tpu_state_dict(m, {**state, "gpt.extra": state["gpt.final_ln.bias"]})
    bad = dict(state)
    bad["gpt.layers.0.qkv.weight"] = bad["gpt.layers.0.qkv.weight"].T
    with pytest.raises(ValueError, match="qkv"):
        load_paddle_tpu_state_dict(m, bad)
    # Linear weights arrive transposed ([in, out] -> [out, in])
    _, t = models
    np.testing.assert_array_equal(
        t.gpt.layers[1].ffn1.weight.detach().numpy(),
        state["gpt.layers.1.ffn1.weight"].T)


def test_no_cache_logits_match(models):
    j, t = models
    ids = np.random.RandomState(3).randint(1, 96, (2, 19)).astype("int64")
    want = j(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = t(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_adapter_prefill_and_steps_match(models):
    """GPTAdapter.prefill over 3 right-padded prompts into a shared pool,
    then three decode steps: logits (atol 1e-4) and pools (atol 1e-5)."""
    j, t = models
    ja, ta = JGPTAdapter(j, PS), GPTAdapter(t, PS)
    params, bufs = ja.params_and_buffers()
    NP, P = 8, 30
    lens = np.asarray([5, 16, 11], "int32")
    rs = np.random.RandomState(4)
    ids = np.zeros((3, 16), "int64")
    for b, n in enumerate(lens):
        ids[b, :n] = rs.randint(1, 96, n)
    table = np.full((3, NP), P - 1, "int32")          # P-1: scratch page
    table[:, :4] = rs.permutation(P - 1)[:12].reshape(3, 4)
    jp = ja.init_pools(P)
    tp = ta.init_pools(P)
    jl, *jp = ja.prefill(params, bufs, jnp.asarray(ids), *jp,
                         jnp.asarray(table), jnp.asarray(lens))
    tl, *tp = ta.prefill(torch.from_numpy(ids), *tp, torch.from_numpy(table),
                         torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    last = np.asarray(jl).argmax(-1)[:, None].astype("int64")
    for _ in range(3):
        jl, *jp = ja.step(params, bufs, jnp.asarray(last), *jp,
                          jnp.asarray(table), jnp.asarray(lens))
        tl, *tp = ta.step(torch.from_numpy(last), *tp, torch.from_numpy(table),
                          torch.from_numpy(lens))
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        last = np.asarray(jl).argmax(-1)[:, None].astype("int64")
        lens = lens + 1
    # real positions only: the pad lanes and the scratch page hold junk
    for a, b in zip(tp, jp):
        a, b = a.numpy(), np.asarray(b)
        for r, n in enumerate(lens):
            for pos in range(n):
                pg, off = table[r, pos // PS], pos % PS
                np.testing.assert_allclose(a[:, pg, off], b[:, pg, off],
                                           atol=1e-5, rtol=0)


def test_adapter_geometry(models):
    j, t = models
    ja, ta = JGPTAdapter(j, PS), GPTAdapter(t, PS)
    assert (ta.num_layers, ta.num_kv_heads, ta.head_dim, ta.max_model_len) == \
        (ja.num_layers, ja.num_kv_heads, ja.head_dim, ja.max_model_len)
    assert ta.page_bytes() == ja.page_bytes()
    assert ta.init_pools(5)[0].shape == ja.init_pools(5)[0].shape


# -------------------------------------------------------------- sampler
@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, 1.0), (7, 0.8),
                                         (0, 0.5)])
def test_top_k_top_p_masks_match(top_k, top_p):
    l = np.random.RandomState(top_k + int(top_p * 10)).randn(6, 40)
    l = l.astype("float32") * 2.0
    want = np.asarray(jdecode.apply_top_k_top_p(jnp.asarray(l), top_k, top_p))
    got = _decode.apply_top_k_top_p(torch.from_numpy(l), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sampler_greedy_rows_exact_and_temperature_frequencies():
    """Greedy rows take the argmax in every draw; a temperature row's
    empirical frequencies over 20000 draws are within 0.015 (about 6
    standard errors of a frequency near 0.3) of softmax(filtered / T)."""
    V, N, T = 12, 20000, 0.8
    logits = np.random.RandomState(5).randn(2, V).astype("float32")
    rows = np.concatenate([np.repeat(logits[:1], N, 0),
                           np.repeat(logits[1:], N, 0)])
    temps = np.concatenate([np.zeros(N), np.full(N, T)]).astype("float32")
    sample = _decode.make_batched_sampler(top_k=8, top_p=0.95)
    gen = torch.Generator().manual_seed(0)
    tok = sample(torch.from_numpy(rows), torch.from_numpy(temps), gen).numpy()
    assert np.all(tok[:N] == logits[0].argmax())
    filt = np.asarray(jdecode.apply_top_k_top_p(
        jnp.asarray(logits[1:] / T), 8, 0.95))[0]
    p = np.exp(filt - filt.max())
    p /= p.sum()
    freq = np.bincount(tok[N:], minlength=V) / N
    assert np.all(freq[p == 0] == 0)
    assert np.max(np.abs(freq - p)) < 0.015
