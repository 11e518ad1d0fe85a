"""Warm restarts: the program ledger + warmup manifests (counterpart of
``examples/serve_gpt_warm.py``; README "PyTorch / CUDA port", program
lifecycle).

A serving process's first request per program-store key pays the key's
first dispatch: on the card the ``nvcc`` build of its kernels, one eager
run and the capture of its CUDA graph; on the CPU one eager run.  This
demo runs the SAME tiny GPT through a cold restart and a warm restart:

- cold: a fresh engine serves one request; its TTFT decomposition
  (``RequestHandle.ttft_breakdown()``) shows where the time went
  (``queue_s / compile_s / prefill_s``), the process-wide
  :class:`~paddle_tpu_torch.observability.programs.ProgramLedger` shows
  every minted program with its stall and the trace id that paid it, and
  ``engine.capture_manifest()`` saves the store's key set;
- warm: a second engine over a fresh same-seed model replays the
  manifest with ``engine.warmup(path)`` BEFORE admission, so its first
  real request mints nothing, its ``compile_s`` is 0 and its greedy ids
  are byte-identical.

Run on the card (the default) or the CPU:

    python -m paddle_tpu_torch.examples.serve_gpt_warm [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from paddle_tpu_torch.observability import programs
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM

PAGE = 16
S0, MAX_NEW = 32, 48


def build_model(device):
    torch.manual_seed(0)
    return GPTForCausalLM(vocab_size=128, hidden_size=128,
                          num_hidden_layers=4, num_attention_heads=4,
                          max_position_embeddings=256, device=device).eval()


def serve_one(engine, prompt):
    with engine:
        h = engine.submit(prompt, max_new_tokens=MAX_NEW)
        ids = list(h.result(timeout=600))
    return ids, h.ttft_breakdown()


def main(device=None, manifest_path=None):
    prompt = np.random.RandomState(0).randint(1, 128, (S0,)).tolist()
    manifest_path = manifest_path or os.path.join(
        tempfile.gettempdir(), "gpt_warm_manifest.json")

    # ---------------------------------------------------- cold restart
    print("=== cold restart: first request pays the first dispatches ===")
    model = build_model(device)
    engine = ServingEngine(model, num_slots=4, page_size=PAGE,
                           max_model_len=S0 + MAX_NEW, device=device,
                           replica="warm-demo-cold")
    cold_ids, cold_bd = serve_one(engine, prompt)
    print(f"TTFT {cold_bd['ttft_s']:.3f}s = queue {cold_bd['queue_s']:.4f}s"
          f" + compile {cold_bd['compile_s']:.3f}s"
          f" + prefill {cold_bd['prefill_s']:.4f}s"
          f"  (cold={cold_bd['cold']})")

    led = programs.ledger()
    led.resolve_analysis()  # build vs run + capture split, pool bytes
    print("\nprogram ledger (the /statusz 'programs' table):")
    for row in led.rows(store=None):
        print(f"  {row['family']:<22} {row['cold']:<5}"
              f" compile {row['compile_s'] or 0:.3f}s"
              f" build {row.get('backend_compile_s', 0) or 0:.3f}s"
              f" paid-by {str(row['trace_id'])[:8]}")

    engine.capture_manifest().save(manifest_path)
    n_keys = len(json.load(open(manifest_path))["keys"])
    print(f"\ncaptured {n_keys}-key manifest -> {manifest_path}")

    # ---------------------------------------------------- warm restart
    print("\n=== warm restart: manifest replayed before admission ===")
    model2 = build_model(device)  # a fresh process rebuilds it the same way
    engine2 = ServingEngine(model2, num_slots=4, page_size=PAGE,
                            max_model_len=S0 + MAX_NEW, device=device,
                            replica="warm-demo-warm")
    info = engine2.warmup(manifest_path)
    print(f"warmup replayed {info['warmed']} programs"
          f" in {info['seconds']:.2f}s (skipped {info['skipped']})")

    traces0 = engine2.program_traces()
    warm_ids, warm_bd = serve_one(engine2, prompt)
    warm_traces = engine2.program_traces() - traces0

    print(f"TTFT {warm_bd['ttft_s']:.4f}s, compile"
          f" {warm_bd['compile_s']:.1f}s, new mints {warm_traces}")
    print(f"\ncold TTFT {cold_bd['ttft_s']:.3f}s ->"
          f" warm TTFT {warm_bd['ttft_s']:.4f}s")
    assert warm_traces == 0, "a warmed engine must mint nothing"
    assert warm_bd["compile_s"] == 0.0, "a warmed request pays no stall"
    assert warm_ids == cold_ids, "greedy output must be byte-identical"
    print("OK: zero mints after warmup, byte-identical greedy output")
    return {"cold_ids": cold_ids, "warm_ids": warm_ids,
            "warm_traces": warm_traces, "cold": cold_bd, "warm": warm_bd,
            "warmup": info}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
