"""Numerics-debugging walkthrough (counterpart of
``examples/numerics_debugging.py``; :mod:`paddle_tpu_torch.observability
.numerics`).

The whole loop, end to end, on the card (the default) or the CPU:

1. eager checks: ``check_numerics`` + ``collect_operator_stats`` (the
   ``paddle.amp.debugging`` API) on a tiny model;
2. in-step probes: a ``TrainStep`` runs its probed variant, whose extra
   output is a per-site stats table (layer activations, the loss, every
   gradient), resolved off the step by ``numerics.poll()``;
3. forensics: the ``numerics.nan_inject`` fault site poisons one step,
   the anomaly engine names the first offending layer in ONE
   flight-recorder dump and ``poll`` raises ``NumericFault``;
4. recovery: a ``RecoverySupervisor`` classifies the fault as
   ``"numeric"``, rolls back to the last VALID checkpoint and the rerun
   finishes with a clean loss.

    python -m paddle_tpu_torch.examples.numerics_debugging [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import jit, nn, optimizer as opt
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.random import seed
from paddle_tpu_torch.observability import faults, flight_recorder, numerics
from paddle_tpu_torch.resilience import (AsyncCheckpointManager,
                                         RecoverySupervisor)
from paddle_tpu_torch.resilience.retry import RetryPolicy

TOTAL_STEPS = 6


def build(device):
    seed(7)
    m = nn.Sequential(nn.Linear(8, 32), nn.Tanh(), nn.Linear(32, 4)).to(device)
    o = opt.Momentum(learning_rate=0.05, momentum=0.9,
                     parameters=m.parameters())
    return m, o


def main(device=None):
    device = resolve_device(device)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(16, 8).astype("float32")).to(device)
    y = torch.from_numpy(rs.randint(0, 4, (16,)).astype("int64")).to(device)

    # ------------------------------------------------------ 1. eager checks
    print("== eager: check_numerics + collect_operator_stats ==")
    m, _ = build(device)
    stats = numerics.check_numerics(m(x), name="logits")
    print(f"logits: absmax={stats['absmax']:.3f} rms={stats['rms']:.3f} "
          f"nonfinite={int(stats['nonfinite'])}")
    with numerics.collect_operator_stats(model=m) as col:
        m(x)
    print(col.report())

    # ---------------------------------------------- 2. probed TrainStep
    print("\n== in-step probes: one probed TrainStep variant ==")
    flight_dir = tempfile.mkdtemp(prefix="paddle_numerics_flight_")
    flight_recorder.get_flight_recorder().dir = flight_dir
    numerics.enable_tensor_checker(level="dump")   # warn | dump | abort

    m, o = build(device)
    step = jit.TrainStep(m, o, loss_fn=nn.CrossEntropyLoss())
    print(f"step 0: loss={float(step(x, y)):.4f}")
    numerics.poll()                                # resolve OFF the step
    table = numerics.latest(step._perf_tag)
    print(f"probed sites ({len(table['sites'])}): {', '.join(table['sites'])}")

    # ---------------------------------------- 3. nan_inject -> one dump
    print("\n== forensics: numerics.nan_inject names the first bad layer ==")
    faults.inject("numerics.nan_inject", times=1)  # next probed step poisoned
    float(step(x, y))
    # the step's own throttled maybe_poll may have resolved the table
    # already; the monitor keeps the episode either way
    ep = (numerics.poll() or numerics.monitor().episodes())[0]
    print(f"anomaly: kind={ep.kind} site={ep.site!r} stream={ep.stream}")
    with open(ep.dump) as f:
        doc = json.load(f)
    worst = [r for r in doc["extra"]["stats"] if r["nonfinite"] > 0][0]
    print(f"flight dump -> {ep.dump}")
    print(f"first offending tensor in the dump: {worst['tensor']!r}")

    # --------------------------------- 4. NumericFault -> checkpoint rollback
    print("\n== recovery: supervisor rolls back past the poisoned step ==")
    numerics.reset()
    numerics.enable_tensor_checker(level="abort")  # poll() now raises
    ckpt_dir = tempfile.mkdtemp(prefix="paddle_numerics_ckpt_")
    mgr = AsyncCheckpointManager(ckpt_dir, max_to_keep=4)
    faults.inject("numerics.nan_inject", at_trips={3})  # poison step 2, try 1
    attempts = []

    def train_fn(start, state):
        attempts.append(start)
        m, o = build(device)                       # fresh params per attempt
        st = jit.TrainStep(m, o, loss_fn=nn.CrossEntropyLoss())
        loss = None
        for s in range(start, TOTAL_STEPS):
            loss = float(st(x, y))
            numerics.poll()                        # raises NumericFault on NaN
            mgr.save(s + 1, {"marker": torch.tensor(np.float32(s + 1),
                                                    device=device)},
                     block=True)
            print(f"  step {s}: loss={loss:.4f} (checkpointed)")
        return loss

    sup = RecoverySupervisor(
        mgr, policy=RetryPolicy(base_delay=0.05, max_delay=0.1, seed=0),
        max_numeric_restarts=2, device=device,
        on_restart=lambda kind, exc, n: print(
            f"  !! {kind} failure ({exc}); rolling back to last valid "
            f"checkpoint"))
    final = sup.run(train_fn)
    mgr.close()

    assert np.isfinite(final), "rerun should be clean"
    assert sup.restarts.get("numeric") == 1
    assert len(attempts) == 2 and attempts[1] >= 1  # rolled back, not replayed
    print(f"\nfinal loss {final:.4f} after {len(attempts)} attempts "
          f"(restart budget used: {sup.restarts})")
    print("numerics observability round trip: probe -> dump -> rollback OK")
    return {"sites": list(table["sites"]), "anomaly_kind": ep.kind,
            "anomaly_site": ep.site, "first_bad_tensor": worst["tensor"],
            "attempts": attempts, "restarts": dict(sup.restarts),
            "final_loss": final}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
