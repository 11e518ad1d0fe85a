"""Multi-tenant serving: paged multi-LoRA + grammar-constrained decoding
+ embedding requests on ONE engine (counterpart of
``examples/serve_gpt_multitenant.py``; README "PyTorch / CUDA port").

A small GPT is overfit on a cyclic token stream, three LoRA "fine-tunes"
are registered into one rank-bucketed :class:`LoRAStore`, and a SINGLE
batch then serves:

- three requests on three DIFFERENT adapters (a per-row paged adapter
  gather inside one decode program — the mint count proves no per-adapter
  program);
- one JSON-schema-constrained row (a token FSM masks the sampler every
  step, so the output parses under the schema by construction);
- one embedding request (one dispatch against the scratch page, retired
  without touching a single KV page — asserted).

Each adapter row is then replayed on a dedicated single-tenant engine to
show the mixed batch is byte-identical per row.

Run on the card (the default) or the CPU:

    python -m paddle_tpu_torch.examples.serve_gpt_multitenant [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch.serving.multitenant import (
    LoRAAdapter, LoRAStore, MultiTenantEngine, compile_json_schema,
)
from paddle_tpu_torch.text.models import GPTForCausalLM

PAGE = 16
S0, MAX_NEW = 24, 48
VSIZE = 128

SCHEMA = {"type": "object",
          "properties": {"x": {"type": "integer"},
                         "ok": {"type": "boolean"}}}


def build_model(device, period=8, train_steps=150):
    torch.manual_seed(0)
    m = GPTForCausalLM(vocab_size=VSIZE, hidden_size=128,
                       num_hidden_layers=4, num_attention_heads=4,
                       max_position_embeddings=256, device=device)
    cyc = (np.arange(256 + 64) % period + 1).astype("int64")
    o = optimizer.AdamW(learning_rate=3e-3, parameters=m.parameters())
    step = jit.TrainStep(m, o, loss_fn=None)
    ids = torch.as_tensor(np.stack([cyc[i:i + 64] for i in range(8)]))
    for _ in range(train_steps):
        step({"input_ids": ids, "labels": ids})
    return m.eval(), cyc, period


def build_vocab():
    """Token-id -> string map so the grammar is spellable: JSON machinery
    first, filler for the rest, EOS last."""
    chars = list("0123456789{}[]\",:-abcdefghijklmnopqrstuvwxyz. _")
    vocab = ["<pad>"] + chars + ["true", "false", "null"]
    vocab += [f"<u{i}>" for i in range(VSIZE - 1 - len(vocab))]
    return vocab + ["<eos>"]


def main(device=None):
    print("overfitting the demo model ...")
    model, cyc, period = build_model(device)
    prompts = [cyc[i % period:i % period + S0].tolist() for i in range(5)]
    vocab = build_vocab()
    grammar = compile_json_schema(SCHEMA, vocab, len(vocab) - 1)

    store = LoRAStore(model, capacity=8, ranks=(8,),
                      targets=("qkv", "out_proj"))
    names = ["tenant-a", "tenant-b", "tenant-c"]
    for i, name in enumerate(names):
        store.register(LoRAAdapter.random(model, name, rank=4,
                                          seed=7 + i, scale=0.3))
    print(f"registered adapters: {store.names} "
          f"(rank buckets {store.ranks}, capacity {store.capacity})")

    def engine_():
        return MultiTenantEngine(model, lora_store=store, num_slots=4,
                                 page_size=PAGE, max_model_len=S0 + MAX_NEW,
                                 device=device)

    engine = engine_()
    with engine:
        engine.generate(prompts[0], max_new_tokens=4, timeout=600)  # build
        print("\n-- ONE batch: 3 adapters + 1 schema row + 1 embed row --")
        tenant_handles = {n: engine.submit(p, max_new_tokens=MAX_NEW,
                                           adapter=n)
                          for n, p in zip(names, prompts)}
        schema_handle = engine.submit(prompts[3], max_new_tokens=MAX_NEW,
                                      grammar=grammar)
        embed_handle = engine.submit(prompts[4], mode="embed")
        tenant_out = {n: h.result(timeout=600)
                      for n, h in tenant_handles.items()}
        schema_out = schema_handle.result(timeout=600)
        embedding = embed_handle.result(timeout=600)
        assert engine.step_traces == 1, "multi-LoRA minted extra programs!"
        assert engine.block_manager.used_pages == 0  # all rows retired
        print(f"decode programs minted: {engine.step_traces} "
              f"(3 adapters, no per-adapter program)")

        text = "".join(vocab[t] for t in schema_out
                       if t != grammar.eos_token_id)
        doc = json.loads(text)          # valid by construction
        print(f"schema-constrained row: {text}  -> parsed {doc}")
        print(f"embedding row: shape {np.asarray(embedding).shape}, "
              f"no KV pages allocated")
        for n in names:
            print(f"  {n}: {tenant_out[n][:10]} ...")
        st = engine._statusz()

    print("\n-- per-row byte-identity vs dedicated engines --")
    for n in names:
        with engine_() as dedicated:
            solo = dedicated.generate(prompts[names.index(n)],
                                      max_new_tokens=MAX_NEW, adapter=n,
                                      timeout=600)
        assert solo == tenant_out[n]
        print(f"  {n}: mixed batch == dedicated engine "
              f"({len(solo)} tokens)")
    print("\n/statusz tenants:",
          json.dumps(st["tenants"], indent=2, default=str))
    return {"tenants": tenant_out, "schema": schema_out, "doc": doc,
            "embedding": np.asarray(embedding)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
