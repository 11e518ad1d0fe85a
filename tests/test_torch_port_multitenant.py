"""PyTorch port, multi-tenant serving: paged multi-LoRA, grammar-constrained
decoding and embed / score requests on ONE engine, held against the JAX
package's ``serving.multitenant`` in one process.

The tiny GPT is the reference tests' (hidden 32, 2 layers, V = 96 with
their JSON-spellable vocab, trained 60 steps); the port's weights come
through ``load_paddle_tpu_state_dict`` and its adapters from the same
seeded ``LoRAAdapter.random`` draws.  Greedy ids are held byte-identical
to the JAX ``MultiTenantEngine``'s (native and int8 pools, with and
without speculation); embeddings and score logprobs within 1e-5 (f32
rounding of two implementations of the same sums).  Every JAX engine gets
its own ``replica=``.  The reference's router / cluster tests and its
bench arm belong to cluster serving and are not mirrored.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.ops import lora as jlora
from paddle_tpu.serving.multitenant import LoRAAdapter as JLoRAAdapter
from paddle_tpu.serving.multitenant import LoRAStore as JLoRAStore
from paddle_tpu.serving.multitenant import MultiTenantEngine as JMTEngine
from paddle_tpu.serving.multitenant import \
    compile_json_schema as j_compile_json_schema
from paddle_tpu.serving.multitenant import compile_regex as j_compile_regex
from paddle_tpu.serving.multitenant import \
    json_schema_to_regex as j_json_schema_to_regex
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.jit.graphs import KEEP
from paddle_tpu_torch.observability import faults
from paddle_tpu_torch.observability import perf as perf_mod
from paddle_tpu_torch.ops import lora as tlora
from paddle_tpu_torch.profiler import metrics as prof_metrics
from paddle_tpu_torch.resilience.retry import TransientError
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.multitenant import (
    CompiledGrammar, LoRAAdapter, LoRAStore, MultiTenantEngine,
    compile_json_schema, compile_regex, json_schema_to_regex,
)
from paddle_tpu_torch.serving.multitenant.lora import _SlotAllocator
from paddle_tpu_torch.serving.speculative import (make_masked_verifier,
                                                  make_verifier)
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from paddle_tpu_torch.text.models._decode import (make_batched_sampler,
                                                  make_masked_batched_sampler)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

PS = 8
MAXLEN = 64
V = 96
CFG = dict(vocab_size=V, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=MAXLEN)

# token id -> string: enough JSON machinery (plus multi-char tokens) that
# the schema grammars are spellable; id V-1 is EOS (the reference tests')
_CHARS = list("0123456789{}[]\",:-abcdefghijklmnopqrstuvwxyz. _")
VOCAB = (["<pad>"] + _CHARS + ["true", "false", "null", "ab", "12",
                               '"x"', '"y"'])
VOCAB += [f"<u{i}>" for i in range(V - 1 - len(VOCAB))] + ["<eos>"]
EOS = V - 1
assert len(VOCAB) == V

SCHEMA = {"type": "object",
          "properties": {"x": {"type": "integer"},
                         "ok": {"type": "boolean"}}}
SCHEMA2 = {"type": "object",
           "properties": {"tag": {"enum": ["x", "y"]},
                          "vals": {"type": "array",
                                   "items": {"type": "integer"},
                                   "minItems": 1, "maxItems": 3}}}

# embeddings / score logprobs: two f32 implementations of the same sums
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny_jax_gpt(train_steps=60, seed=0):
    """The reference tests' model: tiny GPT trained 60 TrainSteps."""
    paddle.seed(seed)
    m = JGPT(**CFG)
    if train_steps:
        o = jopt.AdamW(learning_rate=1e-2, parameters=m.parameters())
        step = paddle.jit.TrainStep(m, o, loss_fn=None)
        ids = paddle.to_tensor(np.random.RandomState(0).randint(
            1, V, (8, 20)).astype("int64"))
        for _ in range(train_steps):
            step({"input_ids": ids, "labels": ids})
    return m.eval()


def _port_of(jm):
    m = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(
        m, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return m.eval()


@pytest.fixture(scope="module")
def jax_model():
    return _tiny_jax_gpt()


@pytest.fixture(scope="module")
def model(jax_model):
    return _port_of(jax_model)


def _make_store(m, capacity=4, ranks=(4,), n=3, scale=0.6, jax=False):
    S, A = (JLoRAStore, JLoRAAdapter) if jax else (LoRAStore, LoRAAdapter)
    store = S(m, capacity=capacity, ranks=ranks, targets=("qkv", "out_proj"))
    for i in range(n):
        store.register(A.random(m, f"t{i}", rank=4, seed=20 + i,
                                scale=scale))
    return store


@pytest.fixture(scope="module")
def store(model):
    return _make_store(model)


@pytest.fixture(scope="module")
def jax_store(jax_model):
    return _make_store(jax_model, jax=True)


def _prompt(n, seed=1):
    return np.random.RandomState(seed).randint(1, V, (n,)).tolist()


def _mt(model, store=None, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", PS)
    kw.setdefault("max_model_len", MAXLEN)
    return MultiTenantEngine(model, lora_store=store, device="cpu", **kw)


_JAX_REPLICA = iter(range(10 ** 6))


def _jmt(model, store=None, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", PS)
    kw.setdefault("max_model_len", MAXLEN)
    return JMTEngine(model, lora_store=store,
                     replica=f"port-mt-{next(_JAX_REPLICA)}", **kw)


def _text(ids):
    return "".join(VOCAB[t] for t in ids if t != EOS)


MIX_PROMPT = _prompt(6, 1)


@pytest.fixture(scope="module")
def jax_mixed(jax_model, jax_store):
    """One JAX engine, the mixed batch (3 adapters + a base row) plus the
    grammar rows and embed / score requests every parity test reads."""
    g1 = j_compile_json_schema(SCHEMA, VOCAB, EOS)
    g2 = j_compile_json_schema(SCHEMA2, VOCAB, EOS)
    out = {}
    with _jmt(jax_model, jax_store) as eng:
        hs = {n: eng.submit(MIX_PROMPT, max_new_tokens=8, adapter=n)
              for n in ("t0", "t1", "t2")}
        hb = eng.submit(MIX_PROMPT, max_new_tokens=8)
        out["mixed"] = {n: h.result(timeout=600) for n, h in hs.items()}
        out["base"] = hb.result(timeout=600)
        hg = [eng.submit(_prompt(6, 30 + i), max_new_tokens=48, grammar=g)
              for i, g in enumerate((g1, g2))]
        out["grammar"] = [h.result(timeout=600) for h in hg]
        p = _prompt(6, 5)
        hv = [eng.submit(p, mode="embed"),
              eng.submit(p, mode="embed", pooling="last"),
              eng.submit(p, mode="score"),
              eng.submit(p, mode="embed", adapter="t0")]
        out["values"] = [np.asarray(h.result(timeout=600)) for h in hv]
        out["keys"] = sorted(repr(k) for k in eng._store()
                             if isinstance(k, tuple) and str(k[0])
                             .startswith("mt_"))
    return out


# ================================================================ grammar
def test_grammar_regex_fsm_units():
    g = compile_regex("(ab|cd)[0-9]{1,2}", VOCAB, EOS)
    jg = j_compile_regex("(ab|cd)[0-9]{1,2}", VOCAB, EOS)
    st = g.start
    m = g.allowed(st)
    ab, a, one = VOCAB.index("ab"), VOCAB.index("a"), VOCAB.index("1")
    assert m[ab] and m[a] and not m[one] and not m[EOS]
    st2 = g.advance(st, ab)
    assert g.allowed(st2)[one] and not g.allowed(st2)[EOS]
    st3 = g.advance(st2, one)
    assert g.is_final(st3) and g.allowed(st3)[EOS]
    # multi-char token walks ("12" covers two digit positions at once)
    assert g.matches([a, VOCAB.index("b"), VOCAB.index("12")])
    assert g.matches([ab, one, EOS])
    assert not g.matches([ab])                  # incomplete
    assert g.advance(st, one) is None           # illegal from start
    assert g.advance_seq(g.start, [ab, one]) == st3   # resume replay
    # the port's token FSM is the reference's, mask for mask
    for seq in ([], [ab], [ab, one], [a, VOCAB.index("b")]):
        np.testing.assert_array_equal(
            g.allowed(g.advance_seq(g.start, seq)),
            jg.allowed(jg.advance_seq(jg.start, seq)))
    with pytest.raises(ValueError):
        compile_regex("a{3,1}", VOCAB, EOS)
    with pytest.raises(ValueError):
        compile_regex("ab", VOCAB, None)        # a grammar needs an EOS


def test_grammar_json_schema_lowering_and_dead_end_pruning():
    for schema in (SCHEMA, SCHEMA2):
        assert json_schema_to_regex(schema) == j_json_schema_to_regex(schema)
    rx = json_schema_to_regex(SCHEMA)
    assert rx.startswith("\\{") and "\"x\"" in rx.replace("\\\"", "\"")
    g = compile_json_schema(SCHEMA, VOCAB, EOS)
    # greedy-walk oracle: ANY mask-legal walk must end in valid JSON
    for pick in (0, -1):
        st, out = g.start, []
        for _ in range(200):
            mask = g.allowed(st)
            tok = int(np.nonzero(mask)[0][pick])
            out.append(tok)
            if tok == EOS:
                break
            st = g.advance(st, tok)
        assert out[-1] == EOS
        doc = json.loads(_text(out))
        assert set(doc) == {"x", "ok"} and isinstance(doc["x"], int)
        assert g.matches(out)
    # optional properties are rejected loudly (not silently dropped)
    with pytest.raises(ValueError):
        json_schema_to_regex({"type": "object",
                              "properties": {"a": {"type": "integer"},
                                             "b": {"type": "integer"}},
                              "required": ["a"]})
    # dead-end pruning: a vocab that cannot spell the pattern fails at
    # compile time instead of stranding a row mid-document
    with pytest.raises(ValueError):
        compile_regex("qqq", ["<pad>", "a", "b", "<eos>"], 3)


# =============================================================== samplers
def test_masked_sampler_all_true_is_the_unmasked_sampler():
    """An all-True mask samples bit-identically (greedy and Gumbel rows,
    same generator offset); a mask forces a legal token, and disallowed
    entries get -1e30 (no NaN at temperature)."""
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(4, V).astype("float32"))
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0])
    plain, masked = make_batched_sampler(), make_masked_batched_sampler()
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    allowed = torch.ones(4, V, dtype=torch.bool)
    assert torch.equal(plain(logits, temps, g1),
                       masked(logits, allowed, temps, g2))
    allowed = torch.zeros(4, V, dtype=torch.bool)
    allowed[:, 7] = True
    assert masked(logits, allowed, temps, g2).tolist() == [7] * 4
    # the verifier twin: all-True masks verify bit-identically
    K = 2
    lg = torch.from_numpy(rs.randn(3, K + 1, V).astype("float32"))
    drafts = torch.from_numpy(rs.randint(0, V, (3, K)))
    dlen = torch.tensor([2, 1, 0])
    t3 = torch.tensor([0.0, 0.8, 0.0])
    a = make_verifier()(lg, drafts, dlen, t3,
                        torch.Generator().manual_seed(5))
    b = make_masked_verifier()(lg, torch.ones(3, K + 1, V, dtype=torch.bool),
                               drafts, dlen, t3,
                               torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ================================================================ lora ops
def test_lora_ops_match_jax_and_null_slot_is_exact_zero():
    """gather / lora_delta / apply_lora against ``paddle_tpu.ops.lora``
    (f32, atol 1e-6: two matmul orders); each row's delta depends on its
    own row only, and the null slot 0 gives an exact zero."""
    rs = np.random.RandomState(0)
    pa = rs.randn(4, 8, 3).astype("float32")
    pa[0] = 0
    pb = rs.randn(4, 3, 6).astype("float32")
    pb[0] = 0
    x = rs.randn(3, 5, 8).astype("float32")
    y = rs.randn(3, 5, 6).astype("float32")
    aid = np.asarray([2, 0, 3], np.int32)
    ta = tlora.gather_adapter(torch.from_numpy(pa), torch.from_numpy(aid))
    tb = tlora.gather_adapter(torch.from_numpy(pb), torch.from_numpy(aid))
    ja = jlora.gather_adapter(pa, aid)
    jb = jlora.gather_adapter(pb, aid)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    got = tlora.apply_lora(torch.from_numpy(x), torch.from_numpy(y), ta, tb)
    want = np.asarray(jlora.apply_lora(x, y, ja, jb))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), y[1])   # null slot: y
    d = tlora.lora_delta(torch.from_numpy(x), ta, tb)
    assert (d[1] == 0).all()
    # row independence: change row 0's input, rows 1.. keep their bits
    x2 = x.copy()
    x2[0] += 1.0
    d2 = tlora.lora_delta(torch.from_numpy(x2), ta, tb)
    assert torch.equal(d2[1:], d[1:])
    with pytest.raises(ValueError):
        tlora.lora_delta(torch.from_numpy(x), ta)


# ============================================================= LoRA store
def test_lora_adapter_random_draws_are_the_references(model, jax_model):
    a = LoRAAdapter.random(model, "a", rank=4, seed=20,
                           targets=("qkv", "out_proj", "ffn1", "ffn2"))
    b = JLoRAAdapter.random(jax_model, "a", rank=4, seed=20,
                            targets=("qkv", "out_proj", "ffn1", "ffn2"))
    assert set(a.weights) == set(b.weights)
    for k in a.weights:
        for u, w in zip(a.weights[k], b.weights[k]):
            np.testing.assert_array_equal(u, w)


def test_lora_store_units(model, jax_model):
    store = LoRAStore(model, capacity=2, ranks=(2, 8))
    jstore = JLoRAStore(jax_model, capacity=2, ranks=(2, 8))
    assert store.signature() == jstore.signature()
    assert store.bucket_for(1) == 0 and store.bucket_for(3) == 1
    with pytest.raises(ValueError):
        store.bucket_for(9)
    assert store.n_args == 2 * 2 * 2            # 2 targets x 2 buckets x A/B
    assert store.family_suffix() == "@lora-r2+8"
    assert store.pool_bytes() == jstore.pool_bytes()
    a1 = LoRAAdapter.random(model, "a1", rank=2, seed=1)
    a2 = LoRAAdapter.random(model, "a2", rank=2, seed=2)
    a3 = LoRAAdapter.random(model, "a3", rank=2, seed=3)
    store.register(a1), store.register(a2), store.register(a3)
    ptrs = [p.data_ptr() for p in store.device_args()]
    l1 = store.acquire("a1")
    l1b = store.acquire("a1")
    assert l1.row == l1b.row and l1.row > 0     # refcount bump, row 0 = null
    l2 = store.acquire("a2")
    assert store.acquire("a3") is None          # both slots pinned
    store.release(l2)                           # a2 idles: evictable
    l3 = store.acquire("a3")
    assert l3.row == l2.row                     # LRU slot reuse
    # page-ins write rows in place: the pool tensors never move
    assert [p.data_ptr() for p in store.device_args()] == ptrs
    store.release(l1), store.release(l1b), store.release(l3)
    # evict: idle ok, unknown raises, held raises
    store.evict("a2")
    with pytest.raises(KeyError):
        store.evict("a2")
    l1 = store.acquire("a1")
    with pytest.raises(RuntimeError):
        store.evict("a1")
    store.release(l1)
    with pytest.raises(KeyError):
        store.acquire("nope")
    # re-register swaps weights for the NEXT request; held-by-live raises
    l1 = store.acquire("a1")
    with pytest.raises(RuntimeError):
        store.register(LoRAAdapter.random(model, "a1", rank=2, seed=9))
    store.release(l1)
    store.register(LoRAAdapter.random(model, "a1", rank=2, seed=9))
    # allocator-level LRU ordering
    al = _SlotAllocator(1)
    r, res, ev = al.acquire("x")
    assert (r, res, ev) == (0, False, None)
    al.release("x")
    r2, res2, ev2 = al.acquire("y")
    assert (r2, ev2) == (0, "x") and not res2


def test_store_pages_in_the_references_rows(model, jax_model):
    """One paged-in adapter: the port's pool rows equal the JAX store's
    (f32, the same padded, scaling-folded arrays)."""
    s = LoRAStore(model, capacity=2, ranks=(4,))
    js = JLoRAStore(jax_model, capacity=2, ranks=(4,))
    s.register(LoRAAdapter.random(model, "r3", rank=3, seed=7,
                                  scaling=0.5))
    js.register(JLoRAAdapter.random(jax_model, "r3", rank=3, seed=7,
                                    scaling=0.5))
    assert s.acquire("r3").row == js.acquire("r3").row
    for p, q in zip(s.device_args(), js.device_args()):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    st = s.stats()
    assert st["adapters"]["r3"] == {"rank_bucket": 4, "resident": True,
                                    "refs": 1}
    assert st["dtype"] == "float32"


def test_rank_bucket_padding_is_exact(model, store, jax_model, jax_store):
    """A rank-3 adapter in the rank-4 bucket pads A / B with zero columns:
    the pairs bite (ids differ from the base model's) and the ids equal
    the JAX engine's."""
    prompt = _prompt(6, 11)
    with _mt(model, store) as e:
        e.register_adapter(LoRAAdapter.random(model, "r3", rank=3, seed=77,
                                              scale=0.6))
        r3 = e.generate(prompt, max_new_tokens=6, adapter="r3", timeout=600)
        base = e.generate(prompt, max_new_tokens=6, timeout=600)
    assert r3 != base
    with _jmt(jax_model, jax_store) as je:
        je.register_adapter(JLoRAAdapter.random(jax_model, "r3", rank=3,
                                                seed=77, scale=0.6))
        assert je.generate(prompt, max_new_tokens=6, adapter="r3",
                           timeout=600) == r3


# ==================================================== multi-LoRA batching
def test_multilora_batch_matches_dedicated_engines_one_program(
        model, store, jax_mixed):
    """>= 3 distinct adapters + the base model in ONE batch: per-row
    greedy ids byte-identical to each adapter's dedicated engine and to
    the JAX engine's mixed batch; one decode program; the base row equals
    a plain ServingEngine's."""
    names = ["t0", "t1", "t2"]
    with _mt(model, store) as eng:
        hs = {n: eng.submit(MIX_PROMPT, max_new_tokens=8, adapter=n)
              for n in names}
        hb = eng.submit(MIX_PROMPT, max_new_tokens=8)
        mixed = {n: h.result(timeout=600) for n, h in hs.items()}
        base = hb.result(timeout=600)
        assert eng.step_traces == 1             # ONE decode program
        keys = sorted(repr(k) for k in eng._store()
                      if isinstance(k, tuple) and str(k[0])
                      .startswith("mt_"))
    assert mixed == jax_mixed["mixed"]
    assert base == jax_mixed["base"]
    assert len({tuple(v) for v in mixed.values()} | {tuple(base)}) >= 3
    # the program keys are the reference's, byte for byte
    assert set(keys) <= set(jax_mixed["keys"])
    for n in names:                             # dedicated single-tenant
        with _mt(model, store) as e2:
            assert e2.generate(MIX_PROMPT, max_new_tokens=8, adapter=n,
                               timeout=600) == mixed[n]
            assert e2.step_traces == 1
    with ServingEngine(model, num_slots=4, page_size=PS,
                       max_model_len=MAXLEN, device="cpu") as plain:
        assert plain.generate(MIX_PROMPT, max_new_tokens=8,
                              timeout=600) == base


def test_hot_swap_registers_without_new_mint(model, store):
    """An adapter registered at runtime serves at once; no program is
    minted for it and the pools are written in place."""
    prompt = _prompt(6, 2)
    with _mt(model, store) as e:
        e.generate(prompt, max_new_tokens=4, adapter="t0", timeout=600)
        t0, mints0 = e.step_traces, e.program_traces()
        ptrs = [p.data_ptr() for p in store.device_args()]
        e.register_adapter(LoRAAdapter.random(model, "hot", rank=4,
                                              seed=99, scale=0.6))
        r = e.generate(prompt, max_new_tokens=8, adapter="hot", timeout=600)
        assert e.step_traces == t0
        b = e.generate(prompt, max_new_tokens=8, timeout=600)
        assert e.program_traces() == mints0
        assert [p.data_ptr() for p in store.device_args()] == ptrs
    assert r != b
    store.evict("hot")


def test_submit_validation(model, store):
    e = _mt(model, store)
    g = compile_json_schema(SCHEMA, VOCAB, EOS)
    with pytest.raises(KeyError):
        e.submit(_prompt(4), adapter="unregistered")
    with pytest.raises(ValueError):
        e.submit(_prompt(4), mode="bogus")
    with pytest.raises(ValueError):
        e.submit(_prompt(4), grammar=g, mode="embed")
    with pytest.raises(ValueError):
        e.submit(_prompt(4), grammar=g, eos_token_id=EOS - 1)
    small = CompiledGrammar("[0-8]+", VOCAB[:10] + ["<eos>"], 10)
    with pytest.raises(ValueError):
        e.submit(_prompt(4), grammar=small)     # vocab-size mismatch
    # the BASE engine rejects every multi-tenant kwarg loudly
    plain = ServingEngine(model, num_slots=2, page_size=PS,
                          max_model_len=MAXLEN, device="cpu")
    for kw in ({"adapter": "t0"}, {"grammar": g}, {"mode": "embed"},
               {"pooling": "last"}):
        with pytest.raises(ValueError):
            plain.submit(_prompt(4), **kw)
    e.stop()


# ===================================================== constrained decode
def test_constrained_rows_emit_valid_json(model, store, jax_mixed):
    """Every schema-constrained row parses as valid JSON under its schema
    (greedy and temperature rows, mixed with a LoRA tenant); the greedy
    rows' ids equal the JAX engine's."""
    g1 = compile_json_schema(SCHEMA, VOCAB, EOS)
    g2 = compile_json_schema(SCHEMA2, VOCAB, EOS)
    corpus = []
    with _mt(model, store) as eng:
        for i, (g, temp) in enumerate([(g1, 0.0), (g2, 0.0), (g1, 0.9),
                                       (g2, 0.9)]):
            corpus.append((g, eng.submit(_prompt(6, 30 + i % 2),
                                         max_new_tokens=48, grammar=g,
                                         temperature=temp)))
        free = eng.submit(_prompt(6, 3), max_new_tokens=8, adapter="t0")
        results = [(g, h.result(timeout=600)) for g, h in corpus]
        free.result(timeout=600)
        assert not eng._constrained             # every mask row reset
        assert eng._h_allowed.all()
    for g, out in results:
        assert out[-1] == EOS                   # stopped ON completion
        doc = json.loads(_text(out))            # 100% validity
        assert set(doc) == set(g.schema["properties"])
        assert g.matches(out)
    assert [results[0][1], results[1][1]] == jax_mixed["grammar"]


def test_mask_buffer_is_copied_only_while_a_constrained_row_lives(
        model, store):
    """The step program's mask input is KEEP (no copy) while no
    constrained row is live; a grammar row feeds it, and after the row
    retires the all-True rows are fed once, then KEEP again."""
    g = compile_regex("[0-9]{1,3}", VOCAB, EOS)
    with _mt(model, store, num_slots=2) as e:
        fed = []
        orig = e._mask_arg

        def spy(key, host):
            got = orig(key, host)
            fed.append("keep" if got is KEEP else
                       ("all" if np.all(host) else "mask"))
            return got

        e._mask_arg = spy
        e.generate(_prompt(6, 4), max_new_tokens=4, timeout=600)
        e.generate(_prompt(6, 8), max_new_tokens=8, grammar=g, timeout=600)
        e.generate(_prompt(6, 4), max_new_tokens=4, timeout=600)
        key = e._step_store_key()
        buf = e._graphs[key].inputs[4]          # the step's mask buffer
        assert buf.dtype == torch.bool and bool(buf.all())
    assert fed[0] == "all"                      # the program's first feed
    assert "mask" in fed
    i = fed.index("mask")
    after = fed[fed.index("all", i):]
    assert after[0] == "all" and set(after[1:]) == {"keep"}


def test_constrained_speculative_byte_parity_and_validity(
        model, store, jax_model, jax_store):
    """Grammar x speculative: greedy constrained output of a k=2 engine is
    byte-identical to the non-speculative constrained engine and to the
    JAX speculative engine's, and schema-valid (temperature too)."""
    g = compile_json_schema(SCHEMA, VOCAB, EOS)
    p = _prompt(6, 2)
    with _mt(model, store, num_slots=2) as ref_eng:
        ref = ref_eng.generate(p, max_new_tokens=48, grammar=g, timeout=600)
    with _mt(model, store, num_slots=2, speculative_k=2) as spec:
        out = spec.generate(p, max_new_tokens=48, grammar=g, timeout=600)
        out2 = spec.generate(p, max_new_tokens=48, grammar=g,
                             temperature=0.8, timeout=600)
        lora_spec = spec.generate(p, max_new_tokens=12, adapter="t1",
                                  timeout=600)
    assert out == ref
    for o in (out, out2):
        doc = json.loads(_text(o))
        assert set(doc) == {"x", "ok"} and g.matches(o)
    jg = j_compile_json_schema(SCHEMA, VOCAB, EOS)
    with _jmt(jax_model, jax_store, num_slots=2, speculative_k=2) as je:
        assert je.generate(p, max_new_tokens=48, grammar=jg,
                           timeout=600) == out
        assert je.generate(p, max_new_tokens=12, adapter="t1",
                           timeout=600) == lora_spec


def test_constrained_draft_containing_eos_is_safe(model, store):
    """A drafter may propose the EOS id; the grammar filter keeps it in an
    accepting state, and the verify-mask chain stops there instead of
    advancing the FSM through EOS."""
    g = compile_regex("[0-9]{1,3}", VOCAB, EOS)
    with _mt(model, store, num_slots=2, speculative_k=2) as e:
        real_propose = e._drafter.propose

        def eos_heavy(sid, max_tokens=None):
            d = real_propose(sid, max_tokens)
            cap = e._spec_k if max_tokens is None \
                else min(e._spec_k, int(max_tokens))
            return ([EOS] + list(d))[:max(cap, 0)] if cap > 0 else []

        e._drafter.propose = eos_heavy
        out = e.generate(_prompt(6, 8), max_new_tokens=12, grammar=g,
                         timeout=600)
    assert g.matches(out)               # completed, engine alive


def test_constrained_budget_exhaustion_reports_truncated(model, store):
    g = compile_json_schema(SCHEMA, VOCAB, EOS)   # needs ~15+ tokens
    with _mt(model, store, num_slots=2) as e:
        h = e.submit(_prompt(6, 12), max_new_tokens=3, grammar=g)
        out = h.result(timeout=600)
        assert h.status == "truncated"
        assert not g.matches(out)
        h2 = e.submit(_prompt(6, 12), max_new_tokens=48, grammar=g)
        h2.result(timeout=600)
        assert h2.status == "completed"
        # open-ended grammar: a cutoff in an ACCEPTING state is complete
        g2 = compile_regex("[0-9]{1,40}", VOCAB, EOS)
        h3 = e.submit(_prompt(6, 12), max_new_tokens=4, grammar=g2)
        out3 = h3.result(timeout=600)
        assert h3.status == "completed" and g2.matches(out3)


# ========================================================== embed / score
def test_embed_score_ride_scheduler_without_pages(model, store, jax_mixed):
    """Embed / score requests complete through the scheduler WITHOUT
    allocating a page, mix with generate rows, and equal the JAX engine's
    values and the port model's own forward (1e-5)."""
    p = _prompt(6, 5)
    with _mt(model, store, num_slots=2) as eng:
        bm = eng.block_manager
        hs = [eng.submit(p, mode="embed"),
              eng.submit(p, mode="embed", pooling="last"),
              eng.submit(p, mode="score"),
              eng.submit(p, mode="embed", adapter="t0")]
        vals = [np.asarray(h.result(timeout=600)) for h in hs]
        assert bm.used_pages == 0               # nothing ever allocated
        hg = eng.submit(p, max_new_tokens=4)    # generate still works
        he2 = eng.submit(p, mode="embed")       # ... with embeds in flight
        hg.result(timeout=600), he2.result(timeout=600)
        assert bm.used_pages == 0
        assert eng.stats()["prefills"] == 1     # only the generate row
    for got, want in zip(vals, jax_mixed["values"]):
        np.testing.assert_allclose(got, want, **VALUE_TOL)
    emb, last, sc, emb_a = vals
    with torch.no_grad():
        hid = model.gpt(torch.as_tensor([p]))[0].float().numpy()
    np.testing.assert_allclose(hid.mean(0), emb, **VALUE_TOL)
    np.testing.assert_allclose(hid[-1], last, **VALUE_TOL)
    w = model.gpt.word_embeddings.weight.detach().numpy()
    logits = hid @ w.T
    lp = logits - logits.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    ref_sc = [float(lp[t - 1, p[t]]) for t in range(1, len(p))]
    assert len(sc) == len(p) - 1
    np.testing.assert_allclose(sc, ref_sc, **VALUE_TOL)
    assert not np.allclose(emb, emb_a, atol=1e-5)   # the tenant bites


def test_prefix_cached_score_and_embed_equal_the_full_dispatch(model, store):
    """Under ``prefix_cache="radix"`` a score / last-pooled embed over a
    resident shared run dispatches only its tail (and the score memo),
    with the same values as the uncached engine."""
    shared = _prompt(24, 6)
    prompts = [shared + _prompt(5, 40 + i) for i in range(2)]
    with _mt(model, store, num_slots=2) as plain:
        want = [(np.asarray(plain.submit(q, mode="score").result(600)),
                 np.asarray(plain.submit(q, mode="embed", pooling="last")
                            .result(600))) for q in prompts]
    with _mt(model, store, num_slots=2, prefix_cache="radix") as cached:
        cached.generate(shared + [1], max_new_tokens=2, timeout=600)
        got = [(np.asarray(cached.submit(q, mode="score").result(600)),
                np.asarray(cached.submit(q, mode="embed", pooling="last")
                           .result(600))) for q in prompts]
        fams = {r["program"] for r in perf_mod.snapshot()}
        assert cached.block_manager.used_pages == 0
    assert any("@score@cached" in f for f in fams), fams
    for (gs, ge), (ws, we) in zip(got, want):
        np.testing.assert_allclose(gs, ws, **VALUE_TOL)
        np.testing.assert_allclose(ge, we, **VALUE_TOL)


# ================================================== quant x LoRA + chaos
def test_int8_lora_matches_jax_and_restart_is_byte_stable():
    """int8 KV pages + int8 base weights + f32 adapter pools: the port's
    ids equal the JAX int8 multi-tenant engine's; a TransientError
    mid-serve rebuilds the KV pools while the adapter pools survive, and
    the restarted run's ids are byte-identical to the uninterrupted one."""
    jm = _tiny_jax_gpt()                        # weight conversion mutates
    m1, m2 = _port_of(jm), _port_of(jm)
    js = _make_store(jm, scale=0.1, jax=True)
    s1, s2 = _make_store(m1, scale=0.1), _make_store(m2, scale=0.1)
    prompts = [_prompt(6, 40 + i) for i in range(3)]
    names = ["t0", "t1", "t2"]

    def batch(engine):
        with engine:
            hs = [engine.submit(p, max_new_tokens=10, adapter=n)
                  for n, p in zip(names, prompts)]
            return {n: h.result(timeout=600) for n, h in zip(names, hs)}

    kw = dict(num_slots=3, kv_dtype="int8", weight_dtype="int8")
    eq = _mt(m1, s1, **kw)
    assert eq._decode_family() == "decode@int8@lora-r4"
    qout = batch(eq)
    assert qout == batch(_jmt(jm, js, **kw))
    eq2 = _mt(m2, s2, **kw)

    def boom():
        raise TransientError("injected")

    faults.inject("serving.step_crash", fn=boom, at_trips={2})
    try:
        rout = batch(eq2)
    finally:
        faults.clear()
    assert eq2._engine_restarts >= 1            # the crash fired
    assert rout == qout                         # byte-stable across restart
    assert all(info["resident"] for info in
               s2.stats()["adapters"].values())


# ==================================================== observability/perf
def test_tenant_metrics_statusz_and_perf_families(model, store):
    reqs = prof_metrics.counter("serving.tenant.requests")
    toks = prof_metrics.counter("serving.tenant.tokens")
    e = _mt(model, store, replica="mt-obs")
    base_r = reqs.get(adapter="t1", replica="mt-obs") or 0
    with e:
        e.generate(_prompt(6, 7), max_new_tokens=5, adapter="t1",
                   timeout=600)
        e.generate(_prompt(6, 7), max_new_tokens=3, timeout=600)
        # twice: a family's first dispatch is its mint, not device time
        e.submit(_prompt(6, 7), mode="embed").result(timeout=600)
        e.submit(_prompt(6, 7), mode="embed").result(timeout=600)
        st = e._statusz()
    assert (reqs.get(adapter="t1", replica="mt-obs") or 0) == base_r + 1
    assert (toks.get(adapter="t1", replica="mt-obs") or 0) >= 5
    assert (toks.get(adapter="base", replica="mt-obs") or 0) >= 3
    assert "t1" in st["tenants"]
    assert st["tenants"]["t1"]["rank_bucket"] == 4
    assert st["lora_pools"]["capacity"] == 4
    assert st["multitenant"]["lora"]["adapters"]["t1"]["resident"]
    assert e._decode_family() == "decode@lora-r4"
    assert e._prefill_family(16) == "prefill/16@lora-r4"
    fams = {row["program"] for row in perf_mod.snapshot()}
    assert any(f.startswith("decode@lora-r4") for f in fams), fams
    assert any("@embed" in f for f in fams), fams
    hint = perf_mod.candidate_hint("decode@lora-r4", "bandwidth-bound")
    assert "adapter" in hint or "LoRA" in hint or "rank" in hint
    assert "embed" in perf_mod.candidate_hint("prefill/16@embed",
                                              "bandwidth-bound")
    # the HBM pre-flight holds the adapter pools fixed
    assert e._fixed_bytes == ServingEngine._fixed_bytes.fget(e) \
        + store.pool_bytes()


def test_warmup_replays_mt_keys_and_guards_the_adapter(model, store):
    """A multi-tenant engine's manifest (its ``mt_*`` keys) warms a second
    engine, whose first requests then mint nothing; a plain engine's
    manifest is refused (the adapter signature differs)."""
    with _mt(model, store, num_slots=2) as e:
        e.generate(_prompt(6, 9), max_new_tokens=4, adapter="t2",
                   timeout=600)
        man = e.capture_manifest()
    w = _mt(model, store, num_slots=2)
    info = w.warmup(man)
    assert info["warmed"] >= 2
    t0 = w.program_traces()
    with w:
        w.generate(_prompt(6, 9), max_new_tokens=4, adapter="t2",
                   timeout=600)
    assert w.program_traces() == t0
    with ServingEngine(model, num_slots=2, page_size=PS,
                       max_model_len=MAXLEN, device="cpu") as plain:
        plain.generate(_prompt(6, 9), max_new_tokens=2, timeout=600)
        pman = plain.capture_manifest()
    with pytest.raises(ValueError):
        _mt(model, store, num_slots=2).warmup(pman)
