"""Quantized serving: int8 paged KV-cache pages + int8 weights
(counterpart of ``examples/serve_gpt_quantized.py``).

A small GPT is overfit on a cyclic token stream (wide greedy logit gaps,
so rounding error is visible as token flips if the quantization were
sloppy), then the same requests run through the engine three ways:

- reference: ``ServingEngine(model, ...)`` — full-precision pools;
- int8 KV:   ``ServingEngine(model, ..., kv_dtype="int8")`` — int8 page
  pools with parallel per-(page slot, head) scale pools; quant is fused
  into every pool write, dequant into the paged-attention kernel, so no
  full-precision cache copy ever exists in device memory;
- int8 KV + int8 weights: ``weight_dtype="int8"`` additionally converts
  the decoder Linears to ``Int8Linear`` in place (int8 x int8 -> int32
  products).  The reference arm runs FIRST because the conversion is
  in-place.

Printed at the end: top-1 agreement of each quantized arm against the
reference stream, bytes per KV token / resident-slot occupancy at a fixed
page-pool budget, and the calibration harness's per-layer error report.
On the card the int8 arms decode through the dequantizing paged kernel:

    python -m paddle_tpu_torch.examples.serve_gpt_quantized [--device cpu]
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.observability import memory
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.quant import calibrate, top1_agreement
from paddle_tpu_torch.text.models import GPTForCausalLM

PAGE = 16
S0, MAX_NEW = 32, 64


def build_model(period=8, train_steps=150, device=None):
    """Overfit a small GPT on phase-shifted cycles (heads=2 keeps
    head_dim=64 — the production-shaped ratio where int8 pools fit ~1.9x
    the 16-bit slots per byte)."""
    torch.manual_seed(0)
    m = GPTForCausalLM(vocab_size=128, hidden_size=128, num_hidden_layers=4,
                       num_attention_heads=2, max_position_embeddings=256,
                       device=device)
    cyc = (np.arange(256 + 64) % period + 1).astype("int64")
    o = opt.AdamW(learning_rate=3e-3, parameters=m.parameters())
    step = jit.TrainStep(m, o, loss_fn=None)
    ids = torch.from_numpy(np.stack([cyc[i:i + 64] for i in range(8)])).to(
        m.gpt.word_embeddings.weight.device)
    for _ in range(train_steps):
        step({"input_ids": ids, "labels": ids})
    # drop the training-only state (AdamW moments) before serving: the
    # memory ledger reconciles against the allocator's live bytes, and
    # optimizer state would sit there as untracked bytes the serving
    # process never actually needs
    del o, step, ids
    gc.collect()
    return m.eval(), cyc, period


def run_engine(model, prompts, **kw):
    engine = ServingEngine(model, num_slots=4, page_size=PAGE,
                           max_model_len=S0 + MAX_NEW, **kw)
    with engine:
        engine.generate(prompts[0], max_new_tokens=4, timeout=600)  # warm
        handles = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        outs = [h.result(timeout=600) for h in handles]
        stats = engine.stats()
        # reconcile the memory ledger against the allocator while the
        # engine (and hence its pool registrations) is alive
        stats["memory_report"] = memory.ledger().report()
    return outs, stats


def _fmt_bytes(n):
    return "not measured (no allocator on the CPU)" if n is None \
        else f"{n:,} B"


def main(device=None):
    print("overfitting the demo model ...")
    model, cyc, period = build_model(device=device)
    prompts = [cyc[i % period:i % period + S0] for i in range(8)]

    print("\n-- calibration harness (no conversion yet) --")
    rep = calibrate(model, prompts[:4], max_new_tokens=16, page_size=PAGE,
                    engine_kwargs={"device": device})
    print(f"top-1 agreement on the calibration batch: "
          f"{rep['top1_agreement']:.4f}")
    print(f"per-layer KV round-trip error:   "
          f"{[round(e, 4) for e in rep['per_layer_kv_error']]}")
    worst_w = max(rep["per_layer_weight_error"].items(), key=lambda kv: kv[1])
    print(f"worst weight round-trip error:   {worst_w[0]} = {worst_w[1]:.4f}")

    # reference FIRST: weight conversion below is in-place
    ref, ref_stats = run_engine(model, prompts, device=device)
    int8_kv, kv_stats = run_engine(model, prompts, kv_dtype="int8",
                                   device=device)
    int8_full, full_stats = run_engine(model, prompts, kv_dtype="int8",
                                       weight_dtype="int8", device=device)

    agree_kv = top1_agreement(ref, int8_kv)
    agree_full = top1_agreement(ref, int8_full)
    print("\n-- accuracy --")
    print(f"int8 KV pools      vs reference: top-1 agreement {agree_kv:.4f}")
    print(f"int8 KV + weights  vs reference: top-1 agreement "
          f"{agree_full:.4f}")

    print("\n-- occupancy (one fixed page-pool budget) --")
    bpt_ref = ref_stats["kv_bytes_per_token"]
    bpt_q = kv_stats["kv_bytes_per_token"]
    print(f"KV bytes/token: reference {bpt_ref:.0f} "
          f"({ref_stats['pool_dtype']}), int8 {bpt_q:.0f} "
          f"(payload + scale pools) -> {bpt_ref / bpt_q:.2f}x more "
          f"resident tokens per byte")
    tokens = S0 + MAX_NEW
    budget = ref_stats["num_pages"] * ref_stats["bytes_per_page"]
    slots_ref = (budget // ref_stats["bytes_per_page"]) \
        // -(-tokens // PAGE)
    slots_q = (budget // kv_stats["bytes_per_page"]) \
        // -(-tokens // PAGE)
    print(f"resident {tokens}-token slots at that budget: "
          f"{slots_ref} -> {slots_q} ({slots_q / slots_ref:.2f}x)")

    print("\n-- memory ledger (int8 KV + int8 weights arm) --")
    mrep = full_stats["memory_report"]
    for row in mrep["owners"]:
        print(f"  {row['owner']:<22} {_fmt_bytes(row['bytes']):>16}  "
              f"replica={row['replica']} device={row['device']}")
    frac = mrep["untracked_frac"]
    if frac is None:
        print(f"  tracked {mrep['tracked_bytes']:,} B; live bytes not "
              f"measured (no allocator on the CPU)")
    else:
        print(f"  tracked {mrep['tracked_bytes']:,} B of "
              f"{mrep['live_bytes']:,} B live -> "
              f"untracked_frac {frac:.4f} "
              f"({'OK' if frac <= 0.05 else 'FAIL'}: ledger accounts "
              f"{(1 - frac) * 100:.1f}% of live device bytes)")

    print("\nfirst request, last 12 tokens of each arm:")
    print("  reference:", ref[0][-12:])
    print("  int8 kv:  ", int8_kv[0][-12:])
    print("  int8 all: ", int8_full[0][-12:])
    return {"calibration": rep, "ref": ref, "int8_kv": int8_kv,
            "int8_full": int8_full, "agreement_kv": agree_kv,
            "agreement_full": agree_full, "kv_bytes_per_token":
                (bpt_ref, bpt_q), "slots": (slots_ref, slots_q),
            "untracked_frac": frac}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
