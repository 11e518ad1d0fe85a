"""Continuous-batching GPT serving: concurrent submitters + streaming
(counterpart of ``examples/serve_gpt_continuous.py``; README "PyTorch /
CUDA port", serving).

- several client threads submit mixed-length requests concurrently;
- one streams tokens as they decode (and cancels early);
- the engine interleaves everything in ONE fixed-shape decode batch,
  backfilling slots as short requests finish;
- the serving.* metrics land in the port's registry (exported under
  PADDLE_METRICS_DIR when set).

On the card the prefill runs the flash-attention kernel and every decode
step the paged-decode kernel:

    python -m paddle_tpu_torch.examples.serve_gpt_continuous [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.profiler import metrics as prof_metrics
from paddle_tpu_torch.serving import ContinuousBatchingPredictor, ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM


def main(device=None):
    torch.manual_seed(0)
    model = GPTForCausalLM(vocab_size=1024, hidden_size=128,
                           num_hidden_layers=4, num_attention_heads=4,
                           max_position_embeddings=256, device=device).eval()
    rs = np.random.RandomState(0)

    engine = ServingEngine(model, num_slots=4, page_size=16,
                           max_model_len=256, prefix_sharing=True,
                           device=device)
    with engine:
        # --- concurrent submitters (mixed lengths: nobody waits for the
        # slowest sequence in the batch) -------------------------------
        results = {}

        def client(name, prompt_len, max_new, temperature):
            prompt = rs.randint(1, 1024, (prompt_len,)).tolist()
            t0 = time.time()
            toks = engine.generate(prompt, max_new_tokens=max_new,
                                   temperature=temperature, timeout=600)
            results[name] = (len(toks), round(time.time() - t0, 3))

        threads = [
            threading.Thread(target=client, args=(f"client{i}", 8 + 4 * i,
                                                  [12, 48, 24, 96][i],
                                                  0.0 if i % 2 else 0.8))
            for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name in sorted(results):
            n, dt = results[name]
            print(f"{name}: {n} tokens in {dt}s")

        # --- streaming + early cancellation (frees the KV pages) ------
        prompt = rs.randint(1, 1024, (12,)).tolist()
        handle = engine.submit(prompt, max_new_tokens=64)
        got = []
        for tok in handle.stream():
            got.append(tok)
            if len(got) == 8:
                break  # closing the iterator cancels the request
        handle._done.wait(60)  # cancellation lands at the next iteration
        free = engine.block_manager.free_pages
        total = engine.block_manager.num_pages
        print(f"streamed {got[:8]} then cancelled; "
              f"pages free: {free}/{total}")

        # --- metrics: the same registry the trainers export ------------
        reg = prof_metrics.get_registry()
        ttft = reg.get("serving.ttft_seconds").labels(replica=engine.replica)
        itl = reg.get("serving.inter_token_seconds").labels(
            replica=engine.replica)
        print(f"TTFT mean {ttft.mean * 1e3:.1f} ms | "
              f"inter-token p50 {itl.quantile(0.5) * 1e3:.2f} ms "
              f"p95 {itl.quantile(0.95) * 1e3:.2f} ms | "
              f"decode-step traces "
              f"{int(prof_metrics.counter('serving.step_traces').total())}")
        stats = engine.stats()
        print(stats)

    # --- the paddle.inference-shaped facade ---------------------------
    ids = np.zeros((3, 16), np.int64)
    for b, n in enumerate((16, 9, 12)):
        ids[b, :n] = rs.randint(1, 1024, (n,))
    with ContinuousBatchingPredictor(model, max_new_tokens=8, num_slots=4,
                                     page_size=16, max_model_len=256,
                                     device=device) as pred:
        pred.get_input_handle("input_ids").copy_from_cpu(ids)
        pred.run()
        out = pred.get_output_handle("output_0").copy_to_cpu()
    print("predictor facade output:", out.shape)
    return {"results": results, "streamed": got, "pages_free": free,
            "num_pages": total, "stats": stats, "predictor_shape": out.shape,
            "predictor_out": out, "predictor_in": ids}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
