"""Multi-replica GPT serving: a ServingCluster with prefix-affinity routing
and cross-replica failover (counterpart of ``examples/serve_gpt_cluster.py``).

- two ServingEngine replicas behind the PrefixAffinityRouter: requests
  sharing a prompt prefix land on the same replica, so its prefix pages
  keep hitting under fan-out;
- mixed-prefix traffic: three prefix templates (three system prompts),
  several requests each, fanned out at once;
- a replica stopped mid-decode: the survivor takes its in-flight requests
  as prompt + tokens so far, and greedy output stays byte-identical to an
  uninterrupted run;
- ``cluster.*`` and per-replica ``serving.*`` series in the port's
  registry.

Runs on the card by default (both replicas on it), or the CPU:

    python -m paddle_tpu_torch.examples.serve_gpt_cluster [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.serving import ServingCluster
from paddle_tpu_torch.text.models import GPTForCausalLM


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    torch.manual_seed(0)
    model = GPTForCausalLM(vocab_size=1024, hidden_size=128,
                           num_hidden_layers=4, num_attention_heads=4,
                           max_position_embeddings=256,
                           device=args.device).eval()
    rs = np.random.RandomState(0)
    kw = {"device": args.device} if args.device else {}
    cluster = ServingCluster(model, replicas=2, num_slots=4, page_size=16,
                             max_model_len=256, prefix_sharing=True, **kw)
    with cluster:
        # mixed-prefix traffic: 3 shared templates x 3 requests
        templates = [rs.randint(1, 1024, (32,)).tolist() for _ in range(3)]
        prompts = [t + rs.randint(1, 1024, (6,)).tolist()
                   for t in templates for _ in range(3)]
        handles = [cluster.submit(p, max_new_tokens=24) for p in prompts]
        for h in handles:
            h.result(timeout=600)
        for g, t in enumerate(templates):
            served_by = {h.replica_history[0]
                         for h, p in zip(handles, prompts) if p[:32] == t}
            print(f"template {g}: affine replica "
                  f"{cluster.router.affine_index(t)}, served by {served_by}")
        print(f"affinity hit rate: {cluster.affinity_hit_rate():.2f}")
        hits = metrics.counter("serving.prefix_cache_hits")
        for e in cluster.engines:
            print(f"replica {e.replica}: prefix-cache hits "
                  f"{int(hits.get(replica=e.replica) or 0)}, pages free "
                  f"{e.block_manager.free_pages}/{e.block_manager.num_pages}")

        # a replica stopped mid-decode: its requests fail over
        p = templates[0] + rs.randint(1, 1024, (4,)).tolist()
        ref = cluster.generate(p, max_new_tokens=32, timeout=600)
        h = cluster.submit(p, max_new_tokens=32)
        while len(h.token_ids) < 4 and not h.done:
            time.sleep(0.001)
        next(e for e in cluster.engines
             if e.replica == h.replica_history[0]).stop()
        toks = h.result(timeout=600)
        print(f"replica path {h.replica_history}: "
              f"{'byte-identical' if toks == ref else 'MISMATCH'} after "
              f"failover ({len(toks)} tokens)")
        print("cluster:", {k: v for k, v in cluster.stats().items()
                           if k in ("rerouted_requests", "affinity")})
        print("health:", cluster.health_state())


if __name__ == "__main__":
    main()
