"""Chaos harness: drive real workloads through injected failures and
measure that they recover (counterpart of
``paddle_tpu/resilience/chaos.py``).

Building blocks:

- :class:`paddle_tpu_torch.observability.faults.FaultPlan` — seeded,
  deterministic fault plans (probabilistic + scheduled injection, scoped
  arming) over the instrumented sites (``serving.scheduler_wedge``,
  ``serving.step_crash``, ``chaos.train_step``);
- :func:`corrupt_checkpoint` — flip or truncate bytes in a committed
  checkpoint so the checksum-manifest fallback path is exercised with real
  on-disk damage, not a mocked verifier;
- :func:`run_smoke` — a short deterministic train loop that takes a
  transient failure mid-run *and* a corrupted newest checkpoint, recovers
  through :class:`~.supervisor.RecoverySupervisor`, and reports what
  happened.
"""

from __future__ import annotations

import os
import tempfile
import time

from .checkpoint import _STEP_RE  # the checkpoint-dir naming scheme


def corrupt_checkpoint(directory, step=None, mode="flip", nbytes=64,
                       filename="arrays.npz"):
    """Damage a committed checkpoint in place (chaos testing only).

    ``directory`` is a checkpoint root (or an ``AsyncCheckpointManager`` —
    a bare path is scanned directly, NOT wrapped in a new manager: a
    manager's startup partial-save GC would race a live writer's
    in-flight tmp directory).  ``mode="flip"`` XORs ``nbytes`` bytes in
    the middle of ``filename``; ``mode="truncate"`` cuts the file in
    half.  Either way the manifest checksum no longer matches, which is
    exactly what ``restore_latest_valid`` must detect.  Returns the
    damaged file path."""
    root = getattr(directory, "directory", None) or os.path.abspath(
        str(directory))
    if step is None:
        steps = [int(m.group(1)) for m in map(_STEP_RE.match,
                                              os.listdir(root)) if m]
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
        step = max(steps)
    path = os.path.join(root, f"step_{int(step):08d}", filename)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if mode == "truncate":
            f.truncate(max(size // 2, 1))
        elif mode == "flip":
            off = max(size // 2 - nbytes // 2, 0)
            f.seek(off)
            chunk = f.read(min(nbytes, size - off))
            f.seek(off)
            f.write(bytes(b ^ 0xFF for b in chunk))
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        f.flush()
        os.fsync(f.fileno())
    return path


def run_smoke(total_steps=6, fail_at=3, directory=None, seed=0,
              device=None):
    """Short end-to-end chaos run.

    Trains a tiny deterministic MLP on ``device`` (None: the card),
    checkpointing every step through
    :class:`~.checkpoint.AsyncCheckpointManager`.  A seeded
    :class:`FaultPlan` raises a :class:`~.retry.CollectiveTimeoutError` at
    step ``fail_at`` AND corrupts the newest on-disk checkpoint first, so
    recovery must classify the failure as transient, detect the corruption
    via the checksum manifest, fall back to the previous valid step, and
    still reach ``total_steps``.  Returns a JSON-able report; raises if
    any recovery invariant fails (a run with a broken resilience stack
    should fail loudly, not report a green smoke)."""
    import numpy as np
    import torch

    from .. import nn
    from ..device import resolve_device
    from ..framework.random import seed as _seed
    from ..observability import faults
    from ..optimizer import Momentum
    from .checkpoint import AsyncCheckpointManager
    from .retry import CollectiveTimeoutError, RetryPolicy
    from .supervisor import RecoverySupervisor

    device = resolve_device(device)
    tmp = None
    if directory is None:
        tmp = tempfile.TemporaryDirectory(prefix="paddle_chaos_smoke_")
        directory = tmp.name
    t_start = time.perf_counter()
    mgr = None
    try:
        mgr = AsyncCheckpointManager(directory, max_to_keep=3)
        losses = {}

        def build():
            _seed(0)
            m = nn.Sequential(nn.Linear(16, 32), nn.Tanh(),
                              nn.Linear(32, 4)).to(device)
            o = Momentum(learning_rate=0.05, momentum=0.9,
                         parameters=m.parameters())
            return m, o

        rs = np.random.RandomState(7)
        x = torch.from_numpy(rs.randn(32, 16).astype("float32")).to(device)
        y = torch.from_numpy(rs.randint(0, 4, (32,)).astype("int64")).to(
            device)
        lossf = nn.CrossEntropyLoss()

        def train_fn(start, state):
            m, o = build()
            if state is not None:
                m.load_state_dict(state["model"])
                o.set_state_dict(state["opt"])
            for step in range(start, total_steps):
                faults.maybe("chaos.train_step")
                loss = lossf(m(x), y)
                loss.backward()
                o.step()
                o.clear_grad()
                losses[step] = loss.item()
                mgr.save(step + 1,
                         {"model": m.state_dict(), "opt": o.state_dict()},
                         block=True)
            return losses

        def sabotage():
            # damage the newest committed checkpoint, then die "transiently"
            corrupt_checkpoint(mgr)
            raise CollectiveTimeoutError(
                f"chaos-smoke: injected collective timeout at step {fail_at}")

        plan = faults.FaultPlan(seed=seed).add(
            "chaos.train_step", fn=sabotage, at_trips={fail_at + 1})
        sup = RecoverySupervisor(
            mgr, policy=RetryPolicy(base_delay=0.01, max_delay=0.05, seed=seed),
            max_transient_restarts=2, device=device)
        with plan:
            sup.run(train_fn)
        mgr.wait_until_finished()

        fallback_step = fail_at - 1  # corrupt step quarantined, resumed 1 back
        if sorted(losses) != list(range(total_steps)):
            raise RuntimeError(f"chaos smoke did not cover every step: "
                               f"{sorted(losses)}")
        if sup.restarts["transient"] != 1:
            raise RuntimeError(
                f"expected exactly 1 transient restart, got {sup.restarts}")
        # the invariant this smoke exists to guard: the damaged checkpoint
        # was caught by its MANIFEST and quarantined (measured, not assumed)
        quarantined = sum(1 for n in os.listdir(directory)
                          if ".corrupt-" in n)
        if quarantined != 1:
            raise RuntimeError(
                f"expected exactly 1 quarantined corrupt checkpoint, found "
                f"{quarantined} under {directory}")
        from ..profiler import metrics as _metrics

        return {
            "completed_steps": total_steps,
            "injected_failure_at_step": fail_at,
            "transient_restarts": sup.restarts["transient"],
            "resumed_from_step": fallback_step,
            "corrupt_checkpoints_quarantined": quarantined,
            "final_loss": losses[total_steps - 1],
            "checkpoint_saves": _metrics.counter(
                "resilience.checkpoint_saves").total(),
            "elapsed_s": round(time.perf_counter() - t_start, 3),
        }
    finally:
        if mgr is not None:
            mgr.close()  # writer thread must not outlive the smoke
        if tmp is not None:
            tmp.cleanup()
