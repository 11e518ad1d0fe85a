"""PyTorch port, the serving slice as a whole: paddle_tpu_torch's
ServingEngine on the CPU against the JAX ServingEngine on the same tiny
converted GPT (num_slots=3, page_size=8, six requests with prompts of 3-40
tokens crossing page and power-of-two bucket edges, more requests than
slots so slots backfill): greedy token ids must be byte-identical per
request.  Also the BlockManager against the JAX one on one allocate/free
script, the ContinuousBatchingPredictor facade, cancellation through an
abandoned stream, EOS retirement, page accounting, stop() semantics and
the device rule (no card and no device= raises)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.serving import BlockManager as JBlockManager
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.serving import (BlockManager, ContinuousBatchingPredictor,
                                      EngineStoppedError, RequestRejectedError,
                                      ServingEngine)
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

CFG = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)
PS = 8
MAXLEN = 64
PROMPT_LENS = (3, 8, 13, 16, 40, 9)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


PROMPTS = [_prompt(n, 2 + i) for i, n in enumerate(PROMPT_LENS)]


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


@pytest.fixture(scope="module")
def jax_tokens(jax_model):
    with JServingEngine(jax_model, num_slots=3, page_size=PS,
                        max_model_len=MAXLEN) as eng:
        hs = [eng.submit(p, max_new_tokens=12) for p in PROMPTS]
        return [h.result(timeout=300) for h in hs]


def _engine(model, **kw):
    kw.setdefault("num_slots", 3)
    return ServingEngine(model, device="cpu", page_size=PS,
                         max_model_len=MAXLEN, **kw)


def test_greedy_tokens_byte_identical_to_jax_engine(model, jax_tokens):
    eng = _engine(model)
    with eng:
        hs = [eng.submit(p, max_new_tokens=12) for p in PROMPTS]
        got = [h.result(timeout=120) for h in hs]
        st = eng.stats()
    assert got == jax_tokens
    assert len({tuple(t) for t in got}) > 1       # the tokens do vary
    assert st["prefills"] == len(PROMPTS)
    assert eng.block_manager.free_pages == eng.block_manager.num_pages


def test_predictor_facade(model, jax_tokens):
    B = 3
    S = max(len(p) for p in PROMPTS[:B])
    ids = np.zeros((B, S), np.int64)
    for b, p in enumerate(PROMPTS[:B]):
        ids[b, :len(p)] = p
    pred = ContinuousBatchingPredictor(model, max_new_tokens=12,
                                       device="cpu", num_slots=2,
                                       page_size=PS, max_model_len=MAXLEN)
    with pred:
        assert pred.get_input_names() == ["input_ids"]
        pred.get_input_handle("input_ids").copy_from_cpu(ids)
        assert pred.run() is True
        out = pred.get_output_handle("output_0").copy_to_cpu()
        (out2,) = pred.run([ids])
    assert out.shape == (B, S + 12)
    np.testing.assert_array_equal(out, out2)
    for b in range(B):
        assert out[b, S:].tolist() == jax_tokens[b]
    with pytest.raises(KeyError):
        pred.get_input_handle("nope")


def test_abandoned_stream_cancels_and_frees_pages(model):
    eng = _engine(model, num_slots=2)
    with eng:
        it = eng.stream(PROMPTS[4], max_new_tokens=20)
        first = [next(it) for _ in range(3)]
        it.close()                               # abandon the iterator
        other = eng.generate(PROMPTS[1], max_new_tokens=4, timeout=60)
        assert eng.drain(timeout=60)
        assert eng.block_manager.free_pages == eng.block_manager.num_pages
    assert len(first) == 3 and len(other) == 4


def test_eos_retires_early(model, jax_tokens):
    eos = jax_tokens[2][4]
    cut = jax_tokens[2].index(eos) + 1
    eng = _engine(model)
    with eng:
        h = eng.submit(PROMPTS[2], max_new_tokens=12, eos_token_id=eos)
        assert h.result(timeout=60) == jax_tokens[2][:cut]
        assert h.status == "completed"


def test_rejects_unservable_and_stop_fails_in_flight(model):
    eng = _engine(model, num_slots=1)
    with pytest.raises(RequestRejectedError) as ei:
        eng.submit(_prompt(60, 1), max_new_tokens=10)
    assert ei.value.reason == "unservable"
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=3)
    eng.start()
    hs = [eng.submit(p, max_new_tokens=40) for p in (PROMPTS[0], PROMPTS[1])]
    eng.stop()
    for h in hs:
        if h.status != "completed":
            with pytest.raises(EngineStoppedError):
                h.result(timeout=10)
    assert eng.block_manager.free_pages == eng.block_manager.num_pages


def test_deadline_expires(model):
    eng = _engine(model, num_slots=1)
    with eng:
        h = eng.submit(PROMPTS[4], max_new_tokens=20, deadline_s=0.0)
        h.result(timeout=60)
    assert h.status == "expired"


def test_scheduler_failure_fails_every_handle(model):
    """A failure inside the scheduler (here: a step that raises) fails every
    in-flight and queued handle instead of hanging them."""
    eng = _engine(model, num_slots=1)

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    eng._adapter.step = boom
    with eng:
        hs = [eng.submit(p, max_new_tokens=5) for p in PROMPTS[:3]]
        for h in hs:
            with pytest.raises(RuntimeError, match="serving engine failed"):
                h.result(timeout=60)
    assert all(h.status == "error" for h in hs)
    assert "injected" in eng.stats()["error"]


def test_no_card_without_device_raises(model):
    """ServingEngine(model) runs on the card; with none it raises rather
    than quietly serving on the CPU."""
    if torch.cuda.is_available():
        m = GPTForCausalLM(device="cpu", **CFG)
        assert ServingEngine(m, page_size=PS).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, page_size=PS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(**CFG)


# ---------------------------------------------------------- block manager
@pytest.mark.parametrize("sharing", [False, True])
def test_block_manager_matches_jax(sharing):
    """One allocate/free script: identical page ids, free counts and
    prefix-sharing hit/miss/eviction counts."""
    ps = 4
    base = list(range(1, 13))
    script = [("a", base + [50], 20), ("a", base + [51], 18),
              ("a", base[:8], 10), ("f", 0), ("a", [9, 9, 9], 7),
              ("f", 1), ("f", 2), ("a", base + [52], 14),
              ("a", list(range(30, 47)), 30), ("f", 3), ("a", base[:4], 40),
              ("f", 4), ("a", list(range(60, 80)), 44), ("f", 5), ("f", 6)]
    kw = dict(prefix_sharing=sharing)
    jb, tb = JBlockManager(11, ps, **kw), BlockManager(11, ps, **kw)
    jallocs, tallocs = [], []
    for op in script:
        if op[0] == "a":
            ja, ta = jb.allocate(op[1], op[2]), tb.allocate(op[1], op[2])
            assert (ja is None) == (ta is None)
            assert jb.can_allocate(op[1], op[2]) == tb.can_allocate(op[1], op[2])
            if ja is not None:
                assert ta.pages == ja.pages
                assert ta.shared_keys == ja.shared_keys
            jallocs.append(ja)
            tallocs.append(ta)
        else:
            ja, ta = jallocs[op[1]], tallocs[op[1]]
            if ja is not None:
                jb.free(ja)
                tb.free(ta)
        assert tb.free_pages == jb.free_pages
        assert tb.used_pages == jb.used_pages
    if sharing:
        jpc, tpc = jb.stats()["prefix_cache"], tb.stats()["prefix_cache"]
        assert (tpc["hits"], tpc["misses"], tpc["evictions"]) == \
            (jpc["hits"], jpc["misses"], jpc["evictions"])
        assert tpc["hits"] > 0 and tpc["evictions"] > 0


def test_prefix_sharing_engine_keeps_tokens(model, jax_tokens):
    """Two live requests sharing a two-page prompt prefix share its pages
    and still decode exactly the unshared engine's tokens."""
    p = PROMPTS[3]                                  # 16 tokens = 2 pages
    eng = _engine(model, prefix_sharing=True)
    with eng:
        hs = [eng.submit(p, max_new_tokens=12) for _ in range(2)]
        got = [h.result(timeout=60) for h in hs]
        st = eng.block_manager.stats()["prefix_cache"]
    assert got == [jax_tokens[3]] * 2
    assert st["hits"] >= 2
