"""Speculative decoding in the serving engine: n-gram drafting +
multi-token paged verification (counterpart of
``examples/serve_gpt_speculative.py``).

A small GPT is overfit on a cyclic token stream so greedy decode emits
genuinely repetitive output — the workload prompt-lookup drafting exists
for.  The same requests then run through the engine twice:

- baseline: ``ServingEngine(model, ...)`` — one token per decode dispatch;
- speculative: ``ServingEngine(model, ..., speculative_k=4)`` — up to 4
  n-gram-drafted tokens verified per dispatch, 1..5 tokens emitted.

Greedy outputs are asserted byte-identical; the side-by-side tokens/sec
and the measured acceptance rate print at the end.  On the card the
verify runs the paged-decode kernel over each slot's drafted positions:

    python -m paddle_tpu_torch.examples.serve_gpt_speculative [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM


def build_repetitive_model(period=8, train_steps=150, device=None):
    """Overfit a small GPT on phase-shifted cycles: the model learns to
    continue the CONTEXT's cycle (phases vary across rows, so absolute
    positions don't give the answer away)."""
    torch.manual_seed(0)
    m = GPTForCausalLM(vocab_size=128, hidden_size=128, num_hidden_layers=4,
                       num_attention_heads=4, max_position_embeddings=256,
                       device=device)
    cyc = (np.arange(256 + 64) % period + 1).astype("int64")
    o = opt.AdamW(learning_rate=3e-3, parameters=m.parameters())
    step = jit.TrainStep(m, o, loss_fn=None)
    ids = torch.from_numpy(np.stack([cyc[i:i + 64] for i in range(8)])).to(
        m.gpt.word_embeddings.weight.device)
    for _ in range(train_steps):
        step({"input_ids": ids, "labels": ids})
    return m.eval(), cyc, period


def run_engine(model, prompts, max_new, speculative_k, device=None):
    engine = ServingEngine(model, num_slots=4, page_size=16,
                           max_model_len=prompts[0].shape[0] + max_new,
                           speculative_k=speculative_k, device=device)
    with engine:
        engine.generate(prompts[0], max_new_tokens=4, timeout=600)  # warm
        t0 = time.time()
        handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [h.result(timeout=600) for h in handles]
        dt = time.time() - t0
        rate = engine.acceptance_rate
        spec = engine.stats().get("speculative")
    return outs, len(prompts) * max_new / dt, rate, spec


def main(device=None):
    print("overfitting a small GPT on a cyclic stream ...")
    model, cyc, period = build_repetitive_model(device=device)
    S0, max_new = 32, 96
    prompts = [cyc[i % period:i % period + S0] for i in range(8)]

    print("baseline engine (1 token / dispatch) ...")
    base, base_tps, _, _ = run_engine(model, prompts, max_new,
                                      speculative_k=0, device=device)
    print("speculative engine (k=4 n-gram drafts / dispatch) ...")
    spec, spec_tps, rate, st = run_engine(model, prompts, max_new,
                                          speculative_k=4, device=device)

    assert base == spec, "greedy outputs must be byte-identical"
    print(f"\nbaseline     : {base_tps:8.1f} tok/s")
    print(f"speculative  : {spec_tps:8.1f} tok/s  "
          f"({spec_tps / base_tps:.2f}x)")
    print(f"acceptance   : {rate:.3f}  "
          f"({st['accepted']}/{st['proposed']} drafts)")
    print("greedy outputs byte-identical: OK")
    return {"base": base, "spec": spec, "base_tps": base_tps,
            "spec_tps": spec_tps, "acceptance_rate": rate, "speculative": st,
            "prompts": prompts}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
