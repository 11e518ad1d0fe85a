"""PyTorch port, the hierarchical KV cache: paddle_tpu_torch's
RadixPrefixIndex, the radix BlockManager, KVSpillTier and
ServingEngine(prefix_cache=..., kv_spill=...) on the CPU against the JAX
package (the tiny trained GPT of test_torch_port_serving.py, converted;
num_slots=2, page_size=8, max_model_len=64).

- The radix index and the radix BlockManager (with and without a spill
  tier) over one scripted operation sequence: the same pages,
  ``cached_pages``, shared keys, stats and summary digests as JAX's.
- KVSpillTier: budget, LRU drops and payload / scale pairs, as JAX's.
- Engine partial-prefix reuse: greedy ids equal to the JAX radix
  engine's, for the plain, chunked, int8 and speculative engines, with
  JAX's hits and ``saved_tokens``; the ``lru`` arm's too.
- Spill and resurrect with every free device page poisoned: only the
  re-paged host bytes can give the reference ids; the spill counts equal
  JAX's.  ``_recover`` clears the tier.
- The snapshot is a copy (the CPU pools are never aliased)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as opt
from paddle_tpu.serving import BlockManager as JBlockManager
from paddle_tpu.serving import KVSpillTier as JKVSpillTier
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.prefix_index import RadixPrefixIndex as JRadix
from paddle_tpu.serving.prefix_index import prefix_digest as jprefix_digest
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.serving import BlockManager, ServingEngine
from paddle_tpu_torch.serving.kv_spill import KVSpillTier
from paddle_tpu_torch.serving.prefix_index import (RadixPrefixIndex,
                                                   prefix_digest)
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


def _engine(model, **kw):
    kw.setdefault("num_slots", 2)
    return ServingEngine(model, device="cpu", page_size=PS,
                         max_model_len=MAXLEN, **kw)


def _jengine(jax_model, **kw):
    """A JAX engine on a replica name of its own: the JAX metrics registry
    is process-wide, and other test files read replica "0"'s series."""
    kw.setdefault("num_slots", 2)
    kw.setdefault("replica", "j-port-pfx")
    return JServingEngine(jax_model, page_size=PS, max_model_len=MAXLEN,
                          **kw)


def _serve(eng, prompts, n=6):
    """Requests one at a time (a deterministic sharing history)."""
    with eng:
        outs = [eng.generate(p, max_new_tokens=n, timeout=300)
                for p in prompts]
    return outs


def _pc(stats):
    """The prefix-cache counters both engines report (the index and spill
    sub-dicts included)."""
    return stats["prefix_cache"]


# ============================================================ radix index
def _blocks(ix, toks):
    return ix.blocks_of(toks, len(toks) // ix.page_size)


def test_radix_index_script_matches_jax():
    """acquire / insert / release / split / evict_one on both indexes: the
    same pages, reactivations, stats, evicted content keys and summary
    digests at every step."""
    rs = np.random.RandomState(0)
    shared = rs.randint(1, 50, 12).tolist()
    prompts = [shared + rs.randint(1, 50, k).tolist() for k in (4, 8, 0, 12)]
    prompts += [shared[:4] + [7] * 8, rs.randint(1, 50, 16).tolist()]
    ixs = (RadixPrefixIndex(4), JRadix(4))
    live = []
    trace = ([], [])
    for step, p in enumerate(prompts * 2):
        for ix, tr in zip(ixs, trace):
            b = _blocks(ix, p)
            pages, reac, tip = ix.acquire(b)
            base = 100 * step
            ix.insert(tip, b[len(pages):],
                      [base + i for i in range(len(b) - len(pages))])
            tr.append((pages, reac, ix.stats(), ix.idle_pages,
                       ix.resident_pages, ix.match_depth(p, len(b))))
        live.append(p)
        if len(live) > 2:
            old = live.pop(0)
            for ix, tr in zip(ixs, trace):
                ix.release(_blocks(ix, old))
                tr.append(("evict", ix.evict_one(), ix.summary()))
    assert trace[0] == trace[1]
    assert ixs[0].stats()["splits"] > 0
    for toks in ([], [1, 2, 3], shared):
        assert prefix_digest(toks) == jprefix_digest(toks)
    with pytest.raises(KeyError):
        ixs[0].release(_blocks(ixs[0], [99] * 8))


class _FakeTier:
    """A snapshot / restore pair over an in-memory page table, in each
    package's host type: (payload int8, scales f32) per page."""

    def __init__(self, torch_side):
        self.torch_side = torch_side
        self.rows = {}

    def snapshot(self, page):
        a, b = np.full((16,), page % 128, np.int8), np.full((6,), page,
                                                             np.float32)
        if self.torch_side:
            return torch.from_numpy(a), torch.from_numpy(b)
        return a, b

    def restore(self, page, payload):
        self.rows[page] = [np.asarray(x).tolist() for x in payload]


@pytest.mark.parametrize("spill", [False, True])
def test_radix_block_manager_script_matches_jax(spill):
    """One allocate / free script through an undersized pool: identical
    pages, ``cached_pages`` and shared keys, free counts, prefix-cache
    stats (hits, misses, evictions, saved_tokens, resurrections, index,
    spill) and index summaries."""
    rs = np.random.RandomState(1)
    heads = [rs.randint(1, 60, 16).tolist() for _ in range(4)]
    script = []
    for i in range(60):
        h = heads[rs.randint(0, 4)]
        p = h[:int(rs.choice([4, 8, 12, 16]))] \
            + rs.randint(1, 60, rs.randint(0, 9)).tolist()
        script.append(("a", p, len(p) + int(rs.randint(1, 9))))
        if i:   # two live sequences at most: idle runs evict and return
            script.append(("f", i - 1))
    sides = []
    for torch_side in (True, False):
        tier = fake = None
        if spill:
            fake = _FakeTier(torch_side)
            tier = (KVSpillTier if torch_side else JKVSpillTier)(
                budget_bytes=40 * 40)
            tier.attach(fake.snapshot, fake.restore)
        bm = (BlockManager if torch_side else JBlockManager)(
            12, 4, radix=True, spill=tier)
        allocs, trace = [], []
        for op in script:
            if op[0] == "a":
                a = bm.allocate(op[1], op[2])
                allocs.append(a)
                trace.append(None if a is None else
                             (a.pages, a.cached_pages, a.shared_keys))
            elif allocs[op[1]] is not None and allocs[op[1]].pages:
                bm.free(allocs[op[1]])
            trace.append((bm.free_pages, bm.used_pages,
                          bm.can_allocate(op[1], len(op[1]) + 4)
                          if op[0] == "a" else None))
        st = bm.stats()["prefix_cache"]
        sides.append((trace, st, bm.index_summary(),
                      fake.rows if fake else None))
    assert sides[0] == sides[1]
    st = sides[0][1]
    assert st["hits"] and st["evictions"] and st["saved_tokens"]
    if spill:
        assert st["spill"]["spills"] and st["resurrections"]


def test_acquire_and_release_run_match_jax():
    """The run sharing of a dispatch that holds no decode slot: the same
    pinned pages, cached count and refcounts as JAX's, with spilled pages
    resurrected and no eviction of another resident prefix."""
    rs = np.random.RandomState(3)
    a, b = rs.randint(1, 60, 24).tolist(), rs.randint(1, 60, 24).tolist()
    trace = []
    for torch_side in (True, False):
        fake = _FakeTier(torch_side)
        tier = (KVSpillTier if torch_side else JKVSpillTier)(
            budget_bytes=4000)
        tier.attach(fake.snapshot, fake.restore)
        bm = (BlockManager if torch_side else JBlockManager)(
            8, 4, radix=True, spill=tier)
        tr = []
        for p, n in ((a, 30), (b, 30), (a, 30)):    # b evicts a to host
            al = bm.allocate(p, n)
            tr.append((al.pages, al.cached_pages))
            bm.free(al)
        for p, lim in ((a, None), (a + [9] * 8, 3), (b[:3], None),
                       (b, None)):
            run = bm.acquire_run(p, limit=lim)
            tr.append((run, bm.free_pages, bm.used_pages))
            if run is not None:
                bm.release_run(p, len(run[0]))
        tr.append((bm.stats()["prefix_cache"], fake.rows))
        assert BlockManager(4, 4).acquire_run(a) is None   # exact-key mode
        trace.append(tr)
    assert trace[0] == trace[1]
    assert trace[0][-1][0]["resurrections"] > 0


def test_spill_tier_budget_and_lru_match_jax():
    def run(cls, torch_side):
        tier = cls(replica="t", budget_bytes=3 * 256)
        store = {}

        def snap(page):
            a = np.full((16,), page, np.int8)
            b = np.full((60,), page, np.float32)
            return (torch.from_numpy(a), torch.from_numpy(b)) \
                if torch_side else (a, b)

        def restore(page, payload):
            store[page] = [np.asarray(x).tolist() for x in payload]

        tier.attach(snap, restore)
        out = [tier.spill((k,), k) for k in range(4)]
        out += [len(tier), tier.contains((0,)), tier.resurrect((2,), 9),
                tier.resurrect((2,), 9), tier.nbytes(), tier.stats()]
        out.append(store)
        tier.clear()
        out.append(tier.stats())
        return out

    assert run(KVSpillTier, True) == run(JKVSpillTier, False)
    assert KVSpillTier(budget_bytes=123).budget_bytes == 123
    assert KVSpillTier().budget_bytes == 256 << 20
    assert KVSpillTier(budget_bytes=10).spill((1,), 0) is False  # unattached


# ==================================================== engine byte parity
SHARED = _prompt(24, 42)                        # 3 pages
PROMPTS = [SHARED + _prompt(6, s) for s in (1, 2, 3)] \
    + [SHARED[:16] + _prompt(10, 4), _prompt(20, 5), SHARED + _prompt(3, 6)]


@pytest.fixture(scope="module")
def jax_radix(jax_model):
    """The JAX radix engine's ids and prefix-cache stats on PROMPTS."""
    eng = _jengine(jax_model, num_pages=14, prefix_cache="radix")
    outs = _serve(eng, PROMPTS)
    return outs, _pc(eng.stats())


@pytest.mark.parametrize("kw", [
    {}, {"prefill_chunk_tokens": 16}, {"kv_dtype": "int8"},
    {"speculative_k": 3}], ids=["plain", "chunked", "int8", "spec"])
def test_partial_prefix_reuse_equals_jax(jax_model, model, jax_radix, kw):
    """Radix reuse changes no token: the port's radix engine gives the JAX
    radix engine's ids and counts (for int8, JAX's int8 radix engine), and
    its own cold engine's ids."""
    if kw:
        want = _serve(_jengine(jax_model, num_pages=14, prefix_cache="radix",
                               **kw), PROMPTS)
    else:
        want = jax_radix[0]
    eng = _engine(model, num_pages=14, prefix_cache="radix", **kw)
    got = _serve(eng, PROMPTS)
    st = eng.stats()
    assert got == want
    assert got == _serve(_engine(model, num_pages=14, **kw), PROMPTS)
    assert _pc(st) == jax_radix[1]
    assert _pc(st)["saved_tokens"] >= 6 * PS
    if "prefill_chunk_tokens" not in kw:
        # every prompt that matched a run started past it
        assert st["cached_prefills"] == 4
    assert eng.block_manager.used_pages == 0


def test_lru_arm_saved_tokens_equal_jax(jax_model, model):
    """The exact-key arm (``prefix_cache="lru"`` = ``prefix_sharing``):
    the same ids, hits and saved tokens as JAX's, and no cached prefill
    (it shares memory, not compute)."""
    want_eng = _jengine(jax_model, num_pages=14, prefix_cache="lru")
    want = _serve(want_eng, PROMPTS)
    for kw in ({"prefix_cache": "lru"}, {"prefix_sharing": True}):
        eng = _engine(model, num_pages=14, **kw)
        assert _serve(eng, PROMPTS) == want
        assert _pc(eng.stats()) == _pc(want_eng.stats())
        assert eng.stats()["cached_prefills"] == 0


def test_validation(model):
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(model, prefix_cache="nope")
    with pytest.raises(ValueError, match="radix"):
        _engine(model, kv_spill=True)
    with pytest.raises(ValueError, match="radix=True"):
        BlockManager(4, 4, spill=KVSpillTier())


def _spill_scenario(eng, poison):
    """Prompt A, then a disjoint B that forces A's idle run out to the
    host tier, then every free device page poisoned, then A' (A's prefix,
    another tail): only the resurrected bytes give A''s reference ids."""
    shared = _prompt(16, 42)                        # 2 pages
    pA, pB, pA2 = shared + _prompt(6, 1), _prompt(40, 9), \
        shared + _prompt(6, 3)
    with eng:
        bm = eng.block_manager
        outs = [eng.generate(pA, max_new_tokens=6, timeout=300),
                eng.generate(pB, max_new_tokens=6, timeout=300)]
        mid = _pc(eng.stats())
        poison(eng, list(bm._free))
        outs.append(eng.generate(pA2, max_new_tokens=6, timeout=300))
        end = _pc(eng.stats())
    return outs, mid, end, (pA, pB, pA2)


def test_spill_resurrect_with_poisoned_pages_equals_jax(jax_model, model):
    import jax.numpy as jnp

    def jpoison(eng, pages):
        pools = eng._pools
        for page in pages:
            pools = tuple(p.at[:, page].set(jnp.full((), 99, p.dtype))
                          for p in pools)
        eng._pools = pools

    def tpoison(eng, pages):
        with torch.inference_mode():
            for p in eng._pools:
                p[:, pages] = 99

    kw = dict(num_slots=1, num_pages=6, prefix_cache="radix", kv_spill=True)
    want = _spill_scenario(_jengine(jax_model, **kw), jpoison)
    got = _spill_scenario(_engine(model, **kw), tpoison)
    assert got[0] == want[0]
    for g, w in zip(got[1:3], want[1:3]):
        # the host bytes differ in type only (numpy vs torch): same counts
        assert g == w
    assert got[1]["spill"]["spills"] >= 2
    assert got[2]["resurrections"] >= 1
    # the cold engine agrees: the poisoned pages were never read
    plain = _engine(model, num_slots=1, num_pages=6)
    assert _serve(plain, got[3]) == got[0]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spill_snapshot_is_a_copy_and_restores_every_pool(model, kv_dtype):
    eng = _engine(model, num_slots=1, num_pages=6, prefix_cache="radix",
                  kv_spill=True, kv_dtype=kv_dtype)
    with torch.inference_mode():
        for i, p in enumerate(eng._pools):
            p[:, 2] = i + 1
        snap = eng._spill_snapshot(2)
        assert len(snap) == len(eng._pools) == (4 if kv_dtype else 2)
        for p in eng._pools:
            p[:, 2] = 0                         # the page is reused
        assert all(bool((s == i + 1).all()) for i, s in enumerate(snap))
        assert all(s.device.type == "cpu" and s.dtype == p.dtype
                   for s, p in zip(snap, eng._pools))
        pools = eng._pools
        eng._spill_restore(3, snap)
        assert all(a is b for a, b in zip(pools, eng._pools))  # in place
        assert all(bool((p[:, 3] == i + 1).all())
                   for i, p in enumerate(eng._pools))


def test_recover_clears_the_spill_tier(model):
    eng = _engine(model, num_slots=1, num_pages=6, prefix_cache="radix",
                  kv_spill=True)
    with eng:
        eng.generate(_prompt(16, 42) + _prompt(6, 1), max_new_tokens=6,
                     timeout=300)
        eng.generate(_prompt(40, 9), max_new_tokens=6, timeout=300)
    tier = eng._spill
    assert tier.nbytes() > 0 and len(tier) > 0
    bm = eng.block_manager
    eng._recover(RuntimeError("chaos"))
    assert tier.nbytes() == 0 and len(tier) == 0
    assert eng.block_manager is not bm
    assert eng.block_manager._spill is tier
    assert eng.stats()["prefix_cache"]["index"]["resident_pages"] == 0
