"""PyTorch port, GPT ``generate()`` and the paged ops under it, held against
the JAX package on the CPU with the same numpy inputs and the same
converted weights (the tiny trained GPT of test_torch_port_serving.py).

- The pool writes byte-equal: generate()'s lock-step prefill / token
  writes (the token write's page clamp too) and the serving engine's
  chunk writes, native and int8, with the lanes past the table dropped as
  JAX's ``mode="drop"`` scatter drops them (a slot at the cap, a slot
  wholly past it).
- ``paged_decode_attend``, ``paged_chunk_attend(_quant)`` and
  ``PagedKVCache`` within 1e-5 (float32; GQA too).
- Greedy ``generate`` ids byte-identical to JAX's: the dense cache, the
  paged cache (with ``max_len`` pre-sizing), ``use_cache=False`` and beam
  search (with ``eos_token_id`` and ``length_penalty``); the same
  ``ValueError`` past ``max_position_embeddings``.
- The masked plain attention promotes bf16 logits with a float32 additive
  mask as JAX does (the dense cache's path, on the card too)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as opt
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
TOL = dict(rtol=1e-5, atol=1e-5)


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


@pytest.fixture(scope="module")
def jax_model():
    return tiny_jax_gpt()


@pytest.fixture(scope="module")
def model(jax_model):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(
        m, {k: np.asarray(v._value) for k, v in jax_model.state_dict().items()})
    return m.eval()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ----------------------------------------------------------- pool writes
@pytest.mark.parametrize("S,pos", [(13, 21), (16, 31), (5, 40)])
def test_lockstep_writes_byte_equal_to_jax(S, pos):
    """Prefill writes (the padded last page zeroed) and one token write,
    including a position past the pool (JAX's dynamic_update_slice clamps
    the page index)."""
    B, PP, ps, h, d = 2, 4, 8, 2, 8
    pages = _rand(1, B, PP, ps, h, d)
    kv, tok = _rand(2, B, S, h, d), _rand(3, B, h, d)
    want = jpa.paged_prefill_write(jnp.asarray(pages), jnp.asarray(kv))
    want = np.asarray(jpa.paged_token_write(want, jnp.asarray(tok),
                                            jnp.int32(pos)))
    tp, tkv, ttok = _t(pages, kv, tok)
    got = tpa.paged_token_write(tpa.paged_prefill_write(tp, tkv), ttok, pos)
    assert got is tp                               # in place
    np.testing.assert_array_equal(got.numpy(), want)


def _chunk_case(seed, C, lens, quant=False):
    """A pool of 13 pages of 4 behind a 3-wide table per slot: lens 2 and
    7 stay inside the table (12 positions); 10 reaches past it by C - 2
    lanes (the cap case); 12 and 13 lie wholly past it.  No table holds
    the pool's last row, 12, as no slot's table holds the engine's
    scratch page (its last row) below its length."""
    rs = np.random.RandomState(seed)
    P, ps, NP, h, d = 13, 4, 3, 2, 8
    B = len(lens)
    table = rs.permutation(P - 1)[:B * NP].reshape(B, NP).astype("int32")
    pool = rs.randn(P, ps, h, d).astype("float32")
    kv = rs.randn(B, C, h, d).astype("float32")
    if quant:
        pool = rs.randint(-127, 128, (P, ps, h, d)).astype("int8")
    return pool, kv, table, np.asarray(lens, "int32")


@pytest.mark.parametrize("lens", [[2, 7, 10], [10, 12], [13, 0]])
@pytest.mark.parametrize("quant", [False, True])
def test_chunk_write_drops_lanes_past_the_table_like_jax(lens, quant):
    """A chunk write of C = 5 tokens per slot: every page a table
    addresses is byte-equal to JAX's; the lanes past NP * ps are dropped,
    so the last real position keeps its own token (a clamp would race it)
    and a slot wholly past the table changes nothing.  JAX's sentinel page
    -1 wraps to the pool's last row under numpy indexing, so its dropped
    lanes land there (the engine's scratch page, never attended); the
    port's leave it untouched."""
    C = 5
    pool, kv, table, ln = _chunk_case(7 + len(lens), C, lens, quant)
    dropped = bool((ln + C > table.shape[1] * pool.shape[1]).any())
    if quant:
        spool = np.random.RandomState(3).rand(*pool.shape[:3]).astype("float32")
        want = jpa.paged_table_chunk_write_quant(
            jnp.asarray(pool), jnp.asarray(spool), jnp.asarray(kv),
            jnp.asarray(table), jnp.asarray(ln))
        tp, ts, tkv, tt, tl = _t(pool, spool, kv, table, ln)
        got = tpa.paged_table_chunk_write_quant(tp, ts, tkv, tt, tl)
        assert got[0] is tp and got[1] is ts
        before = (pool, spool)
    else:
        want = (jpa.paged_table_chunk_write(
            jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(table),
            jnp.asarray(ln)),)
        tp, tkv, tt, tl = _t(pool, kv, table, ln)
        got = (tpa.paged_table_chunk_write(tp, tkv, tt, tl),)
        assert got[0] is tp
        before = (pool,)
    for g, w, b in zip(got, want, before):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g[:-1], w[:-1])
        np.testing.assert_array_equal(g[-1], b[-1])          # dropped
        assert dropped == (not np.array_equal(w[-1], b[-1]))  # JAX wraps
    if lens[0] == 10 and not quant:
        # the cap case: position 11 holds lane 1's token
        np.testing.assert_array_equal(got[0].numpy()[table[0, -1], 3],
                                      kv[0, 1])


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_paged_decode_attend_matches_jax(h, hkv):
    B, PP, ps, d, pos = 3, 4, 8, 16, 19
    q = _rand(1, B, h, d)
    kp, vp = _rand(2, B, PP, ps, hkv, d), _rand(3, B, PP, ps, hkv, d)
    want = np.asarray(jpa.paged_decode_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.int32(pos)))
    got = tpa.paged_decode_attend(*_t(q, kp, vp), pos).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_paged_chunk_attend_matches_jax(quant, h, hkv):
    """C = 5 positions per slot, each with its own length (one slot at the
    table's reach: its lengths clamp at NP * ps)."""
    rs = np.random.RandomState(5)
    B, C, P, ps, NP, d = 3, 5, 16, 8, 4, 16
    q = rs.randn(B, C, h, d).astype("float32")
    table = rs.permutation(P)[:B * NP].reshape(B, NP).astype("int32")
    lens = np.asarray([0, 13, 30], "int32")
    if quant:
        kp = rs.randint(-127, 128, (P, ps, hkv, d)).astype("int8")
        vp = rs.randint(-127, 128, (P, ps, hkv, d)).astype("int8")
        ks = (rs.rand(P, ps, hkv) * 0.02).astype("float32")
        vs = (rs.rand(P, ps, hkv) * 0.02).astype("float32")
        want = jpa.paged_chunk_attend_quant(*(jnp.asarray(x) for x in (
            q, kp, vp, ks, vs, table, lens)))
        got = tpa.paged_chunk_attend_quant(*_t(q, kp, vp, ks, vs, table,
                                               lens))
    else:
        kp = rs.randn(P, ps, hkv, d).astype("float32")
        vp = rs.randn(P, ps, hkv, d).astype("float32")
        want = jpa.paged_chunk_attend(*(jnp.asarray(x) for x in (
            q, kp, vp, table, lens)))
        got = tpa.paged_chunk_attend(*_t(q, kp, vp, table, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_kv_cache_matches_jax_and_raises_on_overflow():
    B, maxp, ps, h, d = 2, 3, 4, 2, 8
    T = maxp * ps
    ks, vs = _rand(1, T, B, h, d), _rand(2, T, B, h, d)
    jc = jpa.PagedKVCache(B, maxp, ps, h, d, dtype=jnp.float32)
    tc = tpa.PagedKVCache(B, maxp, ps, h, d, dtype=torch.float32,
                          device="cpu")
    q = _rand(3, B, h, d)
    for t in range(T):
        jc = jc.append(jnp.asarray(ks[t]), jnp.asarray(vs[t]))
        assert tc.append(*_t(ks[t], vs[t])) is tc
        if t in (0, 5, T - 1):
            np.testing.assert_allclose(tc.attend(torch.from_numpy(q)).numpy(),
                                       np.asarray(jc.attend(jnp.asarray(q))),
                                       **TOL)
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))
    with pytest.raises(RuntimeError, match="overflow"):
        jc.append(jnp.asarray(ks[0]), jnp.asarray(vs[0]))
    with pytest.raises(RuntimeError, match="overflow"):
        tc.append(*_t(ks[0], vs[0]))


def test_masked_attention_promotes_bf16_logits_like_jax():
    """bf16 q / k / v with the dense cache's float32 additive mask: the
    logits promote to float32 before the mask, in both packages."""
    B, S, T, H, D = 2, 3, 7, 2, 16
    q, k, v = (_rand(s, B, n, H, D) for s, n in ((1, S), (2, T), (3, T)))
    mask = np.where(np.arange(T)[None, :] <= 3 + np.arange(S)[:, None],
                    0.0, -1e30).astype("float32")[None, None]
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x).astype("bfloat16") for x in (q, k, v)),
        attn_mask=paddle.to_tensor(mask), training=False)
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask), training=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._value.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


# ------------------------------------------------------------- generate
IDS = np.random.RandomState(1).randint(1, 96, (2, 11)).astype("int64")


@pytest.mark.parametrize("kw,n", [
    (dict(cache_impl="dense"), 14),
    (dict(cache_impl="paged", page_size=8), 14),
    (dict(cache_impl="paged", page_size=4, max_len=40), 9),
    (dict(use_cache=False), 3),
    (dict(decode_strategy="beam_search", num_beams=3), 8),
    (dict(decode_strategy="beam_search", num_beams=4, eos_token_id=None,
          length_penalty=1.0), 8),
], ids=["dense", "paged", "paged_max_len", "no_cache", "beam",
        "beam_length_penalty"])
def test_generate_greedy_ids_equal_jax(jax_model, model, kw, n):
    want = jax_model.generate(paddle.to_tensor(IDS), max_new_tokens=n,
                              temperature=0.0, **kw).numpy()
    got = model.generate(torch.from_numpy(IDS), max_new_tokens=n,
                         temperature=0.0, **kw)
    assert got.dtype == torch.int64 and got.shape == (2, 11 + n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_search_with_eos_equals_jax(jax_model, model):
    """An EOS the beams reach early (taken from the plain beam output):
    finished hypotheses are pooled and the winner padded with EOS.  The
    batch of two against JAX run on each row alone: JAX's own batched call
    raises here (it reads the beam count as the sequence length, so a
    pooled winner shorter than the other row's is never padded), and beam
    search treats the rows independently."""
    plain = jax_model.generate(paddle.to_tensor(IDS), max_new_tokens=8,
                               decode_strategy="beam_search",
                               num_beams=3).numpy()
    kw = dict(decode_strategy="beam_search", num_beams=3,
              eos_token_id=int(plain[0, 13]))
    want = np.concatenate([jax_model.generate(
        paddle.to_tensor(IDS[b:b + 1]), max_new_tokens=8, **kw).numpy()
        for b in range(2)])
    got = model.generate(torch.from_numpy(IDS), max_new_tokens=8, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, -2:] == kw["eos_token_id"]).all()     # padded with EOS
    np.testing.assert_array_equal(
        model.generate(torch.from_numpy(IDS[:1]), max_new_tokens=8,
                       **kw).numpy(), want[:1])


def test_dense_and_paged_agree_and_sampling_is_seeded(model):
    """Both caches give one greedy stream; a sampled call is repeatable
    from its seed and keeps the prompt."""
    ids = torch.from_numpy(IDS)
    dense = model.generate(ids, max_new_tokens=10, temperature=0.0)
    paged = model.generate(ids, max_new_tokens=10, temperature=0.0,
                           cache_impl="paged", page_size=4)
    torch.testing.assert_close(dense, paged, rtol=0, atol=0)
    a, b = (model.generate(ids, max_new_tokens=10, temperature=0.9, top_k=8,
                           seed=3, cache_impl=c) for c in ("dense", "paged"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(a[:, :11], ids)
    assert model.training is False


def test_generate_rejects_what_jax_rejects(jax_model, model):
    long_ids = np.ones((1, 60), np.int64)
    for m, ids in ((jax_model, paddle.to_tensor(long_ids)),
                   (model, torch.from_numpy(long_ids))):
        with pytest.raises(ValueError, match="max_position_embeddings"):
            m.generate(ids, max_new_tokens=8, temperature=0.0)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            m.generate(ids[:, :10], max_new_tokens=4, temperature=0.0,
                       max_len=65)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            m.generate(ids, max_new_tokens=8, use_cache=False)
        with pytest.raises(ValueError, match="cache_impl"):
            m.generate(ids[:, :4], max_new_tokens=2, cache_impl="ring")


@pytest.mark.parametrize("quant", [False, True])
def test_card_routes_equal_the_plain_versions(quant):
    """What the card runs, checked here through K3's / K4's plain
    versions: the chunk attend's [B*C]-row expansion (a contiguous int32
    table copy per row, per-row lengths clamped at the table's reach) and
    paged_decode_attend's identity table over the pools viewed as
    [B*PP, ...] give the CPU paths' results."""
    rs = np.random.RandomState(8)
    B, C, P, ps, NP, h, d = 3, 5, 16, 8, 4, 4, 16
    q = torch.from_numpy(rs.randn(B, C, h, d).astype("float32"))
    table = torch.from_numpy(
        rs.permutation(P)[:B * NP].reshape(B, NP).astype("int32"))
    lens = torch.tensor([0, 13, 30], dtype=torch.int32)
    table2, rows = tpa._expand_rows(table, tpa._chunk_lens(lens, C, NP * ps))
    assert table2.is_contiguous() and table2.dtype == torch.int32
    assert rows.tolist() == [1, 2, 3, 4, 5, 14, 15, 16, 17, 18,
                             31, 32, 32, 32, 32]
    if quant:
        kp, vp = (torch.from_numpy(rs.randint(-127, 128, (P, ps, h, d))
                                   .astype("int8")) for _ in range(2))
        ks, vs = (torch.from_numpy((rs.rand(P, ps, h) * 0.02)
                                   .astype("float32")) for _ in range(2))
        rowwise = tpa.paged_attention_quantized(
            q.reshape(B * C, h, d), kp, vp, ks, vs, table2, rows)
        want = tpa.paged_chunk_attend_quant(q, kp, vp, ks, vs, table, lens)
    else:
        kp, vp = (torch.from_numpy(rs.randn(P, ps, h, d).astype("float32"))
                  for _ in range(2))
        rowwise = tpa.paged_attention(q.reshape(B * C, h, d), kp, vp, table2,
                                      rows)
        want = tpa.paged_chunk_attend(q, kp, vp, table, lens)
    torch.testing.assert_close(rowwise.reshape(B, C, h, d), want, **TOL)
    # the identity table over per-sequence pools
    PP, pos = 4, 27
    pools = torch.from_numpy(rs.randn(2, B, PP, ps, h, d).astype("float32"))
    ident = (torch.arange(B, dtype=torch.int32)[:, None] * PP
             + torch.arange(PP, dtype=torch.int32)[None, :])
    qd = q[:, 0]
    got = tpa.paged_attention(qd, pools[0].view(B * PP, ps, h, d),
                              pools[1].view(B * PP, ps, h, d), ident,
                              torch.full((B,), pos + 1, dtype=torch.int32))
    torch.testing.assert_close(
        got, tpa.paged_decode_attend(qd, pools[0], pools[1], pos), **TOL)
