"""Distributed tracing and forensics walkthrough (counterpart of
``examples/observability_tracing.py``).

Serves a few requests through the continuous-batching engine with span
tracing armed, exports the rank's trace, merges it into one clock-aligned
timeline, writes OTLP JSON, scrapes the live /metrics | /healthz |
/statusz endpoint, then trips the collective watchdog with an injected
hang on an eager ``all_reduce`` in a world of one and reads the flight
record it dumped.

Runs on the card by default, or the CPU:

    python -m paddle_tpu_torch.examples.observability_tracing [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import urllib.request

import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.observability.watchdog import CollectiveWatchdog
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM


def main(device=None, out_dir=None):
    out_dir = out_dir or tempfile.mkdtemp(prefix="paddle_obs_")
    print(f"artifacts -> {out_dir}")

    # ------------------------------------------------------------ tracing
    torch.manual_seed(0)
    model = GPTForCausalLM(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, max_position_embeddings=64,
                           device=device).eval()
    tracer = tracing.Tracer().start()
    kw = {"device": device} if device else {}
    engine = ServingEngine(model, num_slots=2, page_size=8, max_model_len=64,
                           telemetry_port=0, **kw)  # 0 = ephemeral endpoint
    routes = {}
    with engine:
        handles = [engine.submit([1 + i, 2, 3, 4], max_new_tokens=4)
                   for i in range(3)]
        for h in handles:
            h.result(timeout=600)

        # ------------------------------------------------ live telemetry
        srv = obs.telemetry.get_server()
        for route in ("/healthz", "/statusz"):
            resp = urllib.request.urlopen(srv.url + route, timeout=10)
            body = resp.read()
            routes[route] = resp.status
            print(route, "->", body[:120], "…")
        prom = urllib.request.urlopen(srv.url + "/metrics", timeout=10).read()
        metrics_lines = len(prom.decode().splitlines())
        print("/metrics lines:", metrics_lines)
    tracer.stop()

    spans = {}
    for h in handles:
        spans[h.request_id] = [s.name for s in tracer.find(trace_id=h.trace_id)]
        print(f"request {h.request_id}: trace {h.trace_id[:8]}… "
              f"{spans[h.request_id]}")
    steps = tracer.find("serving.decode_step")
    print(f"{len(steps)} decode iterations, each linking its active requests")

    rank_trace = tracer.export_chrome(os.path.join(out_dir, "rank0_spans.json"))
    otlp = tracer.export_otlp(os.path.join(out_dir, "rank0_otlp.json"))

    # ------------------------------------------ cross-rank merged timeline
    merged = tracing.merge_rank_traces(
        [rank_trace], out_path=os.path.join(out_dir, "merged.json"))
    print("merged timeline events:", len(merged["traceEvents"]),
          "| OTLP:", otlp)

    # ---------------------------------------- watchdog + flight recorder
    made = not torch.distributed.is_initialized()
    dist.init_parallel_env(device=device)      # a world of one
    try:
        obs.flight_recorder.enable(dir=os.path.join(out_dir, "flight"))
        x = torch.ones((8, 4), device=model.gpt.word_embeddings.weight.device)
        dist.all_reduce(x)      # warm: the first call sets the backend up
        wd = CollectiveWatchdog(deadline_s=0.3, poll_s=0.05).start()
        obs.faults.inject("collective_hang", seconds=1.0)
        try:
            dist.all_reduce(x)  # hangs ~1 s; the watchdog fires at 0.3 s
        finally:
            obs.faults.clear("collective_hang")
            wd.stop()
        fire = wd.fired[0]
        print(f"watchdog fired: op={fire['op']} "
              f"missing ranks={fire['ranks_missing']}")
        with open(fire["dump_path"]) as f:
            dump = json.load(f)
        open_spans = [s["name"] for s in dump["open_spans"]]
        print("flight record:", fire["dump_path"],
              "| open spans at dump:", open_spans)
        obs.flight_recorder.disable()
    finally:
        if made:
            dist.destroy_process_group()
    return {"spans": spans, "decode_steps": len(steps),
            "merged_events": len(merged["traceEvents"]), "otlp": otlp,
            "routes": routes, "metrics_lines": metrics_lines,
            "watchdog": {"op": fire["op"],
                         "ranks_missing": fire["ranks_missing"]},
            "open_spans": open_spans, "all_reduce": x.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
