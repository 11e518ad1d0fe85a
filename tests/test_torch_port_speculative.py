"""PyTorch port, speculative decoding and chunked prefill: paddle_tpu_torch's
NgramDrafter, verifier and ServingEngine(speculative_k=...,
prefill_chunk_tokens=...) on the CPU against the JAX package on the same
converted tiny GPT (the tiny trained GPT of test_torch_port_serving.py;
num_slots=2, page_size=8, max_model_len=64).

- NgramDrafter proposals equal JAX's on one random register / extend /
  propose / release script.
- The greedy verifier equal to JAX's on the same logits and drafts; the
  temperature rows' rejection sampling within the tolerance of
  tests/test_speculative.py (acceptance within 0.05 of p(d), a rejection
  never resamples the draft).
- The speculative engine, the chunked-prefill engine and both together,
  with native and int8 pools: greedy ids byte-identical to the JAX
  engine's, ``spec_proposed`` / ``spec_accepted`` equal to JAX's, every
  page freed.  The requests cover a repetitive prompt (drafts fire), a
  random one, one decoding up to the model cap (the chunk write's pad
  lanes reach past the table and are dropped) and an EOS inside the
  stream.  A drafter that is always wrong: every draft rejected, the ids
  unchanged."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.serving import NgramDrafter as JNgramDrafter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.speculative import make_verifier as jmake_verifier
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.speculative import NgramDrafter, make_verifier
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


def _greedy_stream(model, prompt, n):
    """The port's generate() ids (held to JAX's in
    test_torch_port_generate.py)."""
    out = model.generate(torch.tensor([prompt]), max_new_tokens=n,
                         temperature=0.0, cache_impl="paged", page_size=PS)
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def requests(model):
    """(prompt, max_new_tokens, eos) per request: a repetitive prompt, a
    random one with an EOS inside its stream, one decoding to the model
    cap, a random 16-token one."""
    rep, cap = [7, 8, 9] * 4, [11, 12, 13] * 6
    eos_p = _prompt(6, 30)
    ref = _greedy_stream(model, eos_p, 12)
    eos = next(t for i, t in enumerate(ref) if i > 2 and t not in ref[:i])
    return [(rep, 12, None), (eos_p, 12, eos), (cap, MAXLEN - len(cap), None),
            (_prompt(16, 5), 10, None)]


def _run(engine_cls, m, requests, **kw):
    with engine_cls(m, num_slots=2, page_size=PS, max_model_len=MAXLEN,
                    **kw) as eng:
        hs = [eng.submit(p, max_new_tokens=n, eos_token_id=e)
              for p, n, e in requests]
        toks = [h.result(timeout=300) for h in hs]
        st = eng.stats()
        free = eng.block_manager.free_pages == eng.block_manager.num_pages
    return toks, st, free


CONFIGS = {
    "spec": dict(speculative_k=4),
    "spec_int8": dict(speculative_k=4, kv_dtype="int8"),
    "chunk": dict(prefill_chunk_tokens=8),
    "chunk_int8": dict(prefill_chunk_tokens=8, kv_dtype="int8"),
    "spec_chunk": dict(speculative_k=3, prefill_chunk_tokens=8),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_greedy_ids_equal_jax(jax_model, model, requests, name):
    kw = CONFIGS[name]
    want, jst, _ = _run(JServingEngine, jax_model, requests, **kw)
    got, st, free = _run(ServingEngine, model, requests, device="cpu", **kw)
    assert got == want
    assert free
    eos = requests[1][2]
    assert got[1][-1] == eos and len(got[1]) < 12       # stopped at EOS
    assert len(got[2]) == MAXLEN - len(requests[2][0])  # up to the cap
    if "speculative_k" in kw:
        assert st["spec_proposed"] == jst["speculative"]["proposed"] > 0
        assert st["spec_accepted"] == jst["speculative"]["accepted"] > 0
        assert st["verify_steps"] > 0
    if "prefill_chunk_tokens" in kw:
        # prompts of 12, 18 and 16 tokens take 2 + 3 + 2 chunks of 8
        assert st["prefill_chunks"] == 7 and st["prefills"] == 4


class _WrongDrafter(NgramDrafter):
    """Proposes a fixed token absent from the greedy stream: every draft
    must be rejected and the ids stay exact."""

    def __init__(self, k, tok):
        super().__init__(k)
        self._tok = int(tok)

    def propose(self, sid, max_tokens=None):
        cap = self.k if max_tokens is None else min(self.k, int(max_tokens))
        return [self._tok] * max(cap, 0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_fully_rejected_drafts_keep_the_ids(model, kv_dtype):
    p = _prompt(9, 33)
    ref = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                        max_model_len=MAXLEN, kv_dtype=kv_dtype)
    with ref:
        want = ref.generate(p, max_new_tokens=10, timeout=300)
    bad = next(t for t in range(95, 0, -1) if t not in want)
    eng = ServingEngine(model, device="cpu", num_slots=1, page_size=PS,
                        max_model_len=MAXLEN, speculative_k=3,
                        kv_dtype=kv_dtype)
    eng._drafter = _WrongDrafter(3, bad)
    with eng:
        got = eng.generate(p, max_new_tokens=10, timeout=300)
        st = eng.stats()
    assert got == want
    assert st["spec_proposed"] > 0 and st["spec_accepted"] == 0


# ------------------------------------------------------------- drafter
def test_ngram_drafter_matches_jax_on_a_random_script():
    rs = np.random.RandomState(4)
    for k, hi, lo in ((4, 3, 1), (2, 2, 2), (5, 4, 1)):
        j, t = JNgramDrafter(k, hi, lo), NgramDrafter(k, hi, lo)
        for _ in range(300):
            op, sid = rs.randint(5), rs.randint(3)
            if op == 0:
                ctx = rs.randint(0, 5, rs.randint(0, 12)).tolist()
                j.register(sid, ctx)
                t.register(sid, ctx)
            elif op == 1 and sid in t._ctx:
                toks = rs.randint(0, 5, rs.randint(1, 4)).tolist()
                j.extend(sid, toks)
                t.extend(sid, toks)
            elif op == 2:
                j.release(sid)
                t.release(sid)
            else:
                cap = None if op == 3 else int(rs.randint(-1, 6))
                assert t.propose(sid, cap) == j.propose(sid, cap)
        assert t._ctx == j._ctx


def test_drafter_and_engine_validation(model):
    for cls in (NgramDrafter, JNgramDrafter):
        with pytest.raises(ValueError):
            cls(k=0)
        with pytest.raises(ValueError):
            cls(k=2, max_ngram=1, min_ngram=2)
    for kw in (dict(speculative_k=-1), dict(prefill_chunk_tokens=-3)):
        with pytest.raises(ValueError):
            ServingEngine(model, device="cpu", **kw)
    eng = ServingEngine(model, device="cpu", prefill_chunk_tokens=0)
    assert eng.stats()["prefill_chunk_tokens"] is None


# ------------------------------------------------------------ verifier
def test_greedy_verifier_equals_jax():
    import jax

    rs = np.random.RandomState(2)
    B, K, V = 6, 3, 11
    logits = rs.randn(B, K + 1, V).astype("float32")
    am = logits.argmax(-1)
    drafts = np.where(rs.rand(B, K) < 0.6, am[:, :K],
                      rs.randint(0, V, (B, K))).astype("int64")
    dlen = np.asarray([0, 1, 2, 3, 3, 2], "int32")
    temps = np.zeros(B, "float32")
    jt, ja = jmake_verifier()(logits, drafts, dlen, temps, jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tt, ta = make_verifier()(*(torch.from_numpy(x) for x in
                               (logits, drafts, dlen, temps)), gen)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.numpy().any() and not ta.numpy().all()


def test_verifier_rejection_sampling_marginals():
    """Temperature rows: draft d is accepted with probability ~p(d) (the
    0.05 of tests/test_speculative.py), a rejection never resamples d, the
    bonus position samples d sometimes; a greedy row in the same batch is
    exact."""
    B, V = 2048, 4
    row = torch.tensor([2.0, 1.0, 0.0, -1.0])
    logits = row.expand(B, 2, V).clone()
    drafts = torch.zeros((B, 1), dtype=torch.int64)
    temps = torch.ones(B)
    temps[0] = 0.0
    gen = torch.Generator().manual_seed(7)
    targets, accept = make_verifier()(logits, drafts,
                                      torch.ones(B, dtype=torch.int32), temps,
                                      gen)
    acc = accept[1:, 0]
    p0 = float(torch.softmax(row, 0)[0])
    assert abs(acc.float().mean().item() - p0) < 0.05
    assert (targets[1:][~acc, 0] != 0).all()
    assert (targets[1:, 1] == 0).any()
    assert bool(accept[0, 0]) and targets[0].tolist() == [0, 0]


def test_cancel_mid_chunked_prefill_frees_pages(model):
    eng = ServingEngine(model, device="cpu", num_slots=2, page_size=PS,
                        max_model_len=MAXLEN, prefill_chunk_tokens=8)
    with eng:
        h = eng.submit(_prompt(40, 62), max_new_tokens=10)
        h.cancel()
        h.result(timeout=300)
        assert h.status == "cancelled" and len(h.token_ids) < 10
        assert len(eng.generate(_prompt(6, 63), max_new_tokens=4,
                                timeout=300)) == 4
        assert eng.block_manager.free_pages == eng.block_manager.num_pages
