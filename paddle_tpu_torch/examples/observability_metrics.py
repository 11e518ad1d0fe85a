"""Observability walkthrough (counterpart of
``examples/observability_metrics.py``): profile a TrainStep run, print
the per-op summary table, and get per-epoch metrics (variants / retraces
/ MFU / dataloader stall) from ``Model.fit`` for free.

    PADDLE_METRICS_DIR=/tmp/obs python -m \\
        paddle_tpu_torch.examples.observability_metrics [--device cpu]
    # -> /tmp/obs/metrics.jsonl, metrics.prom, train_metrics.jsonl,
    #    plus a chrome trace (host events) and torch's device trace

Env knobs (README "Observability"): PADDLE_PROFILER_DIR,
PADDLE_METRICS_DIR, PADDLE_METRICS_FLUSH_SECS, PADDLE_PEAK_FLOPS.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import callbacks, jit, nn
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch import profiler
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.random import seed
from paddle_tpu_torch.hapi import Model


def profile_train_step(steps, batch, device):
    """Profiler around a TrainStep loop: scheduler-driven device trace +
    host op timers -> summary table + chrome-trace export."""
    seed(0)
    model = nn.Sequential(nn.Linear(64, 256), nn.ReLU(),
                          nn.Linear(256, 10)).to(device)
    optim = opt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = jit.TrainStep(model, optim, loss_fn=nn.CrossEntropyLoss())
    x = torch.from_numpy(np.random.RandomState(0)
                         .randn(batch, 64).astype("float32")).to(device)
    y = torch.from_numpy(np.random.RandomState(1)
                         .randint(0, 10, (batch,)).astype("int64")).to(device)

    trace_dir = os.environ.get(
        "PADDLE_PROFILER_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_trace"))
    p = profiler.Profiler(
        scheduler=profiler.make_scheduler(closed=1, ready=1,
                                          record=steps - 2, repeat=1),
        on_trace_ready=profiler.export_chrome_tracing(trace_dir))
    with p:
        for _ in range(steps):
            float(step(x, y))
            p.step(num_samples=batch)
    p.summary(sorted_by="total")          # per-op table to stdout
    cost = step.cost_analysis()
    print("step cost:", cost)             # flops / bytes of the step

    loaded = profiler.load_profiler_result(trace_dir)
    print(f"reloaded {len(loaded.events)} host events from {loaded.path}")
    return {"cost": cost, "events": len(loaded.events), "path": loaded.path}


def fit_with_metrics_logger(epochs, batch, device):
    """Model.fit users get the observability table via one callback."""
    from paddle_tpu_torch.io import TensorDataset

    seed(1)
    net = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4))
    model = Model(net, device=device)
    model.prepare(optimizer=opt.Adam(learning_rate=1e-3,
                                     parameters=net.parameters()),
                  loss=nn.CrossEntropyLoss())
    ds = TensorDataset([np.random.RandomState(0)
                        .randn(256, 16).astype("float32"),
                        np.random.RandomState(1)
                        .randint(0, 4, (256,)).astype("int64")])
    model.fit(ds, batch_size=batch, epochs=epochs, verbose=0, shuffle=False,
              callbacks=[callbacks.MetricsLoggerCallback()])


def main(device=None, steps=6, epochs=2, batch_size=32):
    device = resolve_device(device)
    prof = profile_train_step(steps, batch_size, device)
    fit_with_metrics_logger(epochs, batch_size, device)

    from paddle_tpu_torch.profiler import metrics

    d = metrics.flush()  # one explicit snapshot (flusher also runs if env set)
    if d:
        print(f"metrics snapshot in {d}/metrics.jsonl and {d}/metrics.prom")
    else:
        print("set PADDLE_METRICS_DIR to export metrics snapshots")
    return {"profile": prof, "metrics_dir": d}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    args = ap.parse_args()
    main(args.device, args.steps, args.epochs, args.batch_size)
