"""Tensor-parallel GPT serving: one ServingEngine sharded over a mesh of
two shards, one process each (counterpart of ``examples/serve_gpt_mp.py``).

Demonstrates ``ServingEngine(mesh=[dev, dev])``:

- the paged KV pools split on the KV-head dimension and the decoder
  weights split Megatron-style (qkv / ffn1 column-parallel, out_proj /
  ffn2 row-parallel) over two shards; the engine's process is shard 0 and
  schedules, a follower process holds shard 1 and mirrors each dispatch;
- greedy output byte-identical to the unsharded engine;
- per-shard capacity accounting: ``bytes_per_page`` halves at mp = 2, so
  the same per-card budget admits twice the resident sequences;
- ``ReplicaPool(devices=[dev] * 2, mp=2)``: the pool carves its device
  list into mp-sized meshes behind the prefix-affinity router (with four
  entries, dp 2 x mp 2).

Both shards run on the card by default (two processes on one card, over
gloo), or on the CPU:

    python -m paddle_tpu_torch.examples.serve_gpt_mp [--device cpu]
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.cluster import ReplicaPool
from paddle_tpu_torch.text.models import GPTForCausalLM


def main(device=None):
    dev = torch.device(device or "cuda")
    torch.manual_seed(0)
    # built on the CPU: each shard goes to its card, the full model never
    model = GPTForCausalLM(vocab_size=1024, hidden_size=128,
                           num_hidden_layers=4, num_attention_heads=4,
                           max_position_embeddings=256, device="cpu").eval()
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 1024, (n,)).tolist() for n in (12, 24, 40, 64)]
    print(f"mesh: {[str(dev)] * 2}")

    # --- unsharded reference (on a copy: the engine moves its model) ------
    with ServingEngine(copy.deepcopy(model), num_slots=4, page_size=16,
                       max_model_len=256, device=dev) as eng:
        ref = [eng.generate(p, max_new_tokens=24, timeout=600)
               for p in prompts]
        bpp1 = eng.stats()["bytes_per_page"]

    # --- the same engine, sharded over the mesh ---------------------------
    with ServingEngine(model, num_slots=4, page_size=16, max_model_len=256,
                       mesh=[dev, dev]) as eng:
        hs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        out = [h.result(timeout=600) for h in hs]
        st = eng.stats()
        print(f"mp={st['mp']}: greedy "
              f"{'byte-identical' if out == ref else 'MISMATCH'} "
              f"to the unsharded engine")
        print(f"per-shard bytes/page {st['bytes_per_page']} "
              f"(unsharded {bpp1}) -> same per-card budget holds "
              f"{bpp1 // st['bytes_per_page']}x the pages")
        bm = eng.block_manager
        budget = 64 * bpp1
        resident = bm.max_resident_sequences(256, budget_bytes=budget)
        print(f"resident sequences at a {budget // 1024} KiB budget: "
              f"{resident} (shards={bm.shards})")
        print(f"decode traces: {eng.step_traces} "
              f"(one decode program for the whole mixed batch)")

    # --- dp x mp: the pool carves its device list into mp-sized meshes ----
    with ReplicaPool(model, devices=[dev] * 2, mp=2, num_slots=4,
                     page_size=16, max_model_len=256,
                     replica_prefix="mp") as pool:
        got = pool.engines[0].generate(prompts[0], max_new_tokens=24,
                                       timeout=600)
        pool_mp = pool.engines[0].stats()["mp"]
        print(f"pool of {len(pool)} mp={pool_mp} replica(s): "
              f"{'byte-identical' if got == ref[0] else 'MISMATCH'}")
    return {"ref": ref, "out": out, "mp": st["mp"],
            "bytes_per_page": (bpp1, st["bytes_per_page"]),
            "resident": resident, "shards": bm.shards,
            "step_traces": st["step_traces"], "pool": (len(pool), pool_mp),
            "pool_out": got}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: both shards on the card) or cpu")
    main(ap.parse_args().device)
