"""Performance attribution + SLO walkthrough (counterpart of
``examples/observability_perf.py``; :mod:`paddle_tpu_torch.observability`).

Serves a small mixed workload through the continuous-batching engine
under an SLO policy, trains a few steps, then prints the per-program
roofline attribution report (which program spent the device time, and
whether it is memory- or compute-bound against the card's ceilings), the
SLO attainment / goodput summary, and the live /statusz program table
read from the telemetry port on localhost.

The ceilings are the visible card's datasheet figures
(``PADDLE_PEAK_FLOPS`` / ``PADDLE_HBM_GBS`` override them); the CPU has
none, so there the table's rates print and its shares and regimes stay
empty.

    python -m paddle_tpu_torch.examples.observability_perf [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import urllib.request

import numpy as np
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.observability import perf, telemetry
from paddle_tpu_torch.serving import ServingEngine, SLOPolicy
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM


def main(device=None):
    # --------------------------------------------------- serve under SLO
    torch.manual_seed(0)
    model = GPTForCausalLM(vocab_size=128, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           max_position_embeddings=128, device=device).eval()

    policy = SLOPolicy(ttft_s=30.0, itl_s=5.0, e2e_s=120.0, objective=0.95)
    own_server = telemetry.get_server() is None
    engine = ServingEngine(model, num_slots=2, page_size=16, max_model_len=96,
                           slo=policy, telemetry_port=0, device=device)
    rs = np.random.RandomState(0)
    with engine:
        handles = [
            engine.submit(rs.randint(1, 120, (8,)), max_new_tokens=12),
            engine.submit(rs.randint(1, 120, (8,)), max_new_tokens=8,
                          temperature=0.8),
            engine.submit(rs.randint(1, 120, (24,)), max_new_tokens=10),
        ]
        outs = [h.result(timeout=600) for h in handles]

        slo = engine.slo_accountant.summary()
        print("SLO summary (per replica):")
        print(json.dumps(slo, indent=2))

        url = telemetry.get_server().url
        with urllib.request.urlopen(f"{url}/statusz", timeout=10) as r:
            statusz = json.load(r)
        table = statusz["perf_programs"]
        ridge = table["ridge_flop_per_byte"]
        print(f"\n/statusz perf_programs (ridge "
              f"{'n/a' if ridge is None else f'{ridge:.0f}'} FLOP/byte):")
        for row in table["programs"]:
            print(f"  {row['program']:<16} calls={row['calls']:<5} "
                  f"dev_s={row['device_seconds']:.4f} regime={row['regime']}")

    # ------------------------------------------------ a few train steps
    m = GPTForCausalLM(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=128,
                       device=device)
    o = opt.AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = jit.TrainStep(m, o, loss_fn=None)
    ids = torch.from_numpy(rs.randint(1, 120, (4, 32)).astype("int64")).to(
        m.gpt.word_embeddings.weight.device)
    for _ in range(4):
        step({"input_ids": ids, "labels": ids})

    # --------------------------------------------- the attribution report
    # resolve=True runs the pending cost thunks (one counted forward +
    # backward per program family — exactly what a telemetry scrape is
    # NOT allowed to do)
    rep = perf.report(top=3, resolve=True)
    print("\n" + rep)
    if own_server:
        telemetry.shutdown()   # the server this walkthrough started
    return {"outs": outs, "slo": slo, "statusz_programs": table["programs"],
            "ridge": ridge, "report": rep}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
