"""Fault-tolerant training walkthrough (counterpart of
``examples/resilient_training.py``, over ``paddle_tpu_torch.resilience``).

A deterministic train loop with a real eager collective each step
(``dist.all_reduce``) checkpoints asynchronously (atomic commit +
checksum manifest); then a seeded fault plan injects a transient
collective failure mid-run AND corrupts the newest on-disk checkpoint.
The RecoverySupervisor classifies the failure as transient, backs off
with jitter, detects the corruption via the manifest, falls back to the
previous valid step, and the run still finishes every step — surviving
both failures it was dealt.

Every rank is a process of its own and runs the loop on the same data,
so the collective is a real one between processes; each rank keeps its
checkpoints in ``<dir>/rank<r>`` (a writer queue that drops no save) and
its own fault plan fires on the same collective call of every rank, so
the ranks fail, fall back to the same step and resume together.

    python -m paddle_tpu_torch.examples.resilient_training --nprocs 2 \\
        [--device cpu] [--clean]

``--nprocs N`` starts N rank processes through
``paddle_tpu_torch.distributed.spawn`` (``PADDLE_DISTRI_BACKEND=gloo``
puts them on one card).  ``--clean`` runs without the fault plan (the losses to compare with).
:func:`main` returns this rank's losses by step (a resumed step's last
value), the restarts and the valid checkpoint steps.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework.random import seed
from paddle_tpu_torch.observability import faults
from paddle_tpu_torch.resilience import (
    AsyncCheckpointManager, CollectiveTimeoutError, RecoverySupervisor,
    RetryPolicy, corrupt_checkpoint,
)

TOTAL_STEPS = 8
FAIL_AT = 4      # the collective of step 4 dies (after steps 0..3 trained)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the rank's card unless given (e.g. cpu)")
    ap.add_argument("--clean", action="store_true",
                    help="no injected failure")
    ap.add_argument("--dir", default=None, help="checkpoint root")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="start this many rank processes (spawn)")
    return ap


def main(argv=None, log=print):
    args = _parser().parse_args(argv)
    dist.init_parallel_env(device=args.device)
    dev = dist.env.device()
    rank = dist.get_rank()
    say = log if rank == 0 else (lambda *a: None)
    root = args.dir or tempfile.mkdtemp(prefix="paddle_resilient_")
    ckpt_dir = os.path.join(root, f"rank{rank}")
    say(f"checkpoints -> {ckpt_dir}")
    # a queue deep enough that no save is dropped: every rank commits the
    # same steps, so they all fall back to the same one
    mgr = AsyncCheckpointManager(ckpt_dir, max_to_keep=4,
                                 queue_depth=TOTAL_STEPS)

    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(32, 16).astype("float32")).to(dev)
    y = torch.from_numpy(rs.randint(0, 4, (32,)).astype("int64")).to(dev)
    lossf = nn.CrossEntropyLoss()
    losses = {}

    def train_fn(start, state):
        """Resumable loop: restore, then train steps [start, TOTAL_STEPS)."""
        seed(0)
        m = nn.Sequential(nn.Linear(16, 32), nn.Tanh(),
                          nn.Linear(32, 4)).to(dev)
        o = opt.Momentum(learning_rate=0.05, momentum=0.9,
                         parameters=m.parameters())
        if state is not None:
            m.load_state_dict(state["model"])
            o.set_state_dict(state["opt"])
            say(f"  resumed from checkpoint: step {start}")
        for step in range(start, TOTAL_STEPS):
            # a REAL eager collective between the rank processes — the
            # injected failure below fires inside its dispatch path
            dist.all_reduce(torch.ones(4, device=dev))
            loss = lossf(m(x), y)
            loss.backward()
            o.step()
            o.clear_grad()
            losses[step] = loss.item()
            say(f"  step {step}: loss {losses[step]:.4f}")
            # async: snapshot to host now, write + atomic commit in background
            mgr.save(step + 1, {"model": m.state_dict(),
                                "opt": o.state_dict()})
        mgr.wait_until_finished()
        return "trained"

    def sabotage():
        """The chaos: damage the newest committed checkpoint, then fail the
        collective the way a dying neighbor rank would."""
        mgr.wait_until_finished()
        victim = corrupt_checkpoint(mgr)
        say(f"  !! corrupted newest checkpoint: {victim}")
        raise CollectiveTimeoutError("injected: all_reduce timed out "
                                     "(simulated preempted neighbor)")

    supervisor = RecoverySupervisor(
        mgr,
        policy=RetryPolicy(base_delay=0.05, max_delay=1.0, jitter=0.5, seed=0),
        max_transient_restarts=3, device=dev)
    if args.clean:
        result = supervisor.run(train_fn)
    else:
        plan = faults.FaultPlan(seed=5).add(
            "collective_hang", fn=sabotage, at_trips={FAIL_AT + 1})
        with plan:   # scoped: whatever happens, the faults disarm on exit
            result = supervisor.run(train_fn)

    say(f"result: {result}")
    say(f"transient restarts: {supervisor.restarts['transient']}")
    valid = mgr.valid_steps()
    say(f"valid checkpoints on disk: {valid}")
    quarantined = [n for n in os.listdir(ckpt_dir) if ".corrupt-" in n]
    say(f"quarantined corrupt checkpoints: {quarantined}")
    want = 0 if args.clean else 1
    assert supervisor.restarts["transient"] == want \
        and TOTAL_STEPS in valid
    mgr.close()
    if not args.clean:
        say("survived an injected collective failure + checkpoint corruption.")
    return {"rank": rank, "losses": [losses[s] for s in range(TOTAL_STEPS)],
            "restarts": supervisor.restarts["transient"], "valid": valid,
            "quarantined": len(quarantined)}


def _rank_main(argv):
    main(argv)
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    args = _parser().parse_args()
    if args.nprocs:
        argv = list(sys.argv[1:])
        i = argv.index("--nprocs")
        del argv[i:i + 2]
        dist.spawn(_rank_main, args=(argv,), nprocs=args.nprocs)
    else:
        main()
