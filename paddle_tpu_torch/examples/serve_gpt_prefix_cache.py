"""Hierarchical KV cache: radix prefix index + host spill tier
(counterpart of ``examples/serve_gpt_prefix_cache.py``).

Eight chat-style requests share one 24-token "system prompt" but diverge
afterwards — the workload where exact-key prefix matching scores zero and
the radix tree shines.  The same requests run through the engine three
ways:

- legacy:      ``prefix_sharing=True`` — exact-key block sharing; the
  divergent tails make every request a miss;
- radix:       ``prefix_cache="radix"`` — page-granular radix tree; every
  request after the first reuses the shared-prefix pages and prefill
  starts at ``shared_pages * page_size``;
- radix+spill: ``kv_spill=True`` with an undersized page pool — idle
  prefix pages LRU-evict to host memory (``PADDLE_KV_SPILL_BUDGET_BYTES``)
  and resurrect into free device slots on the next hit, no recompute.

Printed at the end: greedy byte-identity of all three arms (partial reuse
changes WHEN the first token arrives, never WHAT tokens come out), the
hit / saved-token accounting per arm, the spill tier's
spill / resurrect counters, and the memory ledger's ``kv.spilled``
host-tier row next to the device pools.  On the card a cached prefill
runs its uncached tail through the paged-decode kernel:

    python -m paddle_tpu_torch.examples.serve_gpt_prefix_cache [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from paddle_tpu_torch.observability import memory
from paddle_tpu_torch.observability import perf as obs_perf
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM

PAGE = 8
SHARED, TAIL, MAX_NEW = 24, 8, 16          # 3 shared pages + 1 tail page


def build_model(device=None):
    torch.manual_seed(0)
    m = GPTForCausalLM(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=2, max_position_embeddings=128,
                       device=device)
    return m.eval()


def build_prompts(n=8):
    rng = np.random.default_rng(7)
    system = rng.integers(1, 127, size=SHARED).tolist()
    prompts = [system + rng.integers(1, 127, size=TAIL).tolist()
               for _ in range(n)]
    flush = rng.integers(1, 127, size=SHARED + TAIL).tolist()
    return prompts, flush


def run_engine(model, prompts, flush=None, **kw):
    engine = ServingEngine(model, num_slots=4, page_size=PAGE,
                           max_model_len=SHARED + TAIL + MAX_NEW, **kw)
    with engine:
        if flush is not None:
            # one at a time with a disjoint cache-flusher in the middle:
            # pages sit idle between requests, so the undersized pool
            # must evict the shared prefix into the spill tier — and the
            # second half of the prompts resurrects it from host memory
            outs = [engine.submit(p, max_new_tokens=MAX_NEW).result(
                timeout=600) for p in prompts[:4]]
            engine.submit(flush, max_new_tokens=MAX_NEW).result(timeout=600)
            outs += [engine.submit(p, max_new_tokens=MAX_NEW).result(
                timeout=600) for p in prompts[4:]]
        else:
            handles = [engine.submit(p, max_new_tokens=MAX_NEW)
                       for p in prompts]
            outs = [h.result(timeout=600) for h in handles]
        stats = engine.stats()
        # read the ledger while the engine (device pools + host spill
        # tier registrations) is still alive
        stats["memory_owners"] = memory.ledger().owner_rows(
            replica=engine.replica)
    return outs, stats


def show_prefix(tag, stats):
    pc = stats.get("prefix_cache") or {}
    print(f"  {tag:<12} hits {pc.get('hits', 0):>3}  "
          f"misses {pc.get('misses', 0):>3}  "
          f"evictions {pc.get('evictions', 0):>3}  "
          f"saved_tokens {pc.get('saved_tokens', 0):>4}")
    return pc


def main(device=None):
    model = build_model(device)
    prompts, flush = build_prompts()
    print(f"8 prompts: {SHARED}-token shared prefix "
          f"({SHARED // PAGE} pages) + {TAIL}-token unique tail\n")

    legacy, legacy_stats = run_engine(model, prompts, prefix_sharing=True,
                                      device=device)
    fams_legacy = {r["program"] for r in obs_perf.table().snapshot()}
    radix, radix_stats = run_engine(model, prompts, prefix_cache="radix",
                                    device=device)
    fams_radix = {r["program"] for r in obs_perf.table().snapshot()} \
        - fams_legacy
    # undersized pool: 8 pages hold exactly one in-flight request
    # (4 prompt pages + 2 generation pages) plus the idle shared pages
    # only until pressure evicts them into the spill tier
    spill, spill_stats = run_engine(model, prompts, flush=flush,
                                    prefix_cache="radix", kv_spill=True,
                                    num_pages=8, device=device)

    print("-- greedy byte-identity across arms --")
    same_radix = all(a == b for a, b in zip(legacy, radix))
    same_spill = all(a == b for a, b in zip(legacy, spill))
    print(f"  radix       == legacy: {same_radix}")
    print(f"  radix+spill == legacy: {same_spill}")
    if not (same_radix and same_spill):
        raise SystemExit("FAIL: prefix reuse changed generated tokens")

    print("\n-- prefix-cache accounting --")
    pc_legacy = show_prefix("legacy", legacy_stats)
    pc_radix = show_prefix("radix", radix_stats)
    pc_spill = show_prefix("radix+spill", spill_stats)

    sp = (pc_spill.get("spill") or {})
    print("\n-- spill tier (radix+spill arm) --")
    print(f"  spills {sp.get('spills', 0)}  "
          f"resurrections {sp.get('resurrections', 0)}  "
          f"drops {sp.get('drops', 0)}  "
          f"resident entries {sp.get('entries', 0)}  "
          f"host bytes {sp.get('bytes', 0):,}")

    print("\n-- memory ledger (radix+spill arm) --")
    for row in spill_stats["memory_owners"]:
        print(f"  {row['owner']:<22} {row['bytes']:>12,} B  "
              f"device={row['device']}")

    # both arms HIT the same shared pages, but only radix turns the hits
    # into skipped compute: legacy returns cached_pages=0 (memory-only
    # sharing — prefill recomputes from token 0), radix prefill families
    # carry @cached<p> and dispatch only the un-cached tail
    print("\n-- prefill program families --")
    print(f"  legacy: {sorted(f for f in fams_legacy if 'prefill' in f)}")
    print(f"  radix:  {sorted(f for f in fams_radix if 'prefill' in f)}")
    saved = pc_radix.get("saved_tokens", 0)
    total = sum(len(p) for p in prompts)
    print(f"\nradix arm skipped prefill compute for {saved} of {total} "
          f"prompt tokens ({saved / total:.0%}) — same tokens out, "
          f"smaller TTFT.")
    return {"legacy": legacy, "radix": radix, "spill": spill,
            "prefix_cache": {"legacy": pc_legacy, "radix": pc_radix,
                             "radix_spill": pc_spill},
            "memory_owners": spill_stats["memory_owners"],
            "saved_tokens": saved, "prompt_tokens": total}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
