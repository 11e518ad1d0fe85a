"""paddle_tpu_torch.resilience — close the loop from detected failure to
recovery (counterpart of ``paddle_tpu/resilience``).

Four pillars:

- :mod:`.checkpoint` — :class:`AsyncCheckpointManager`: background save
  thread, atomic directory commit with a sha256 manifest
  (:func:`paddle_tpu_torch.io.checkpoint.write_manifest`), partial-save
  garbage collection, quarantine-and-fall-back restore
  (:meth:`~.checkpoint.AsyncCheckpointManager.restore_latest_valid`);
- :mod:`.retry` + :mod:`.supervisor` — failure classification
  (transient preemption/collective-timeout vs fatal program error),
  capped + jittered exponential backoff with a retry budget, and
  :class:`RecoverySupervisor` resuming from the newest *valid* checkpoint;
- :mod:`.emergency` — :func:`arm_emergency_checkpoint`: synchronous
  save triggered by SIGTERM (preemption notice) or a watchdog fire;
- :mod:`.chaos` — the chaos harness: :func:`corrupt_checkpoint` (real
  on-disk damage for the manifest fallback path) and :func:`run_smoke`,
  driving :class:`paddle_tpu_torch.observability.faults.FaultPlan` fault
  plans.

Serving-side resilience (health state machine, load shedding, engine
auto-restart with in-flight requeue) lives in
:mod:`paddle_tpu_torch.serving.engine` and reuses :mod:`.retry`'s
classification.  Metrics: ``resilience.restarts``,
``resilience.backoff_seconds``, ``resilience.checkpoint_saves``,
``resilience.checkpoint_save_seconds``,
``resilience.checkpoint_saves_dropped``,
``resilience.checkpoint_corruptions``, ``resilience.emergency_saves``.
"""

from __future__ import annotations

from . import chaos, checkpoint, emergency, retry, supervisor  # noqa: F401
from .checkpoint import (  # noqa: F401
    AsyncCheckpointManager, CheckpointCorruptionError,
)
from .chaos import corrupt_checkpoint, run_smoke  # noqa: F401
from .emergency import arm_emergency_checkpoint  # noqa: F401
from .retry import (  # noqa: F401
    CollectiveTimeoutError, EngineStoppedError, NumericFault, PreemptionError,
    RetryPolicy, TransientError, classify_failure, derive_seed,
)
from .supervisor import RecoverySupervisor  # noqa: F401

__all__ = [
    "checkpoint", "retry", "supervisor", "emergency", "chaos",
    "AsyncCheckpointManager", "CheckpointCorruptionError",
    "RecoverySupervisor", "RetryPolicy", "classify_failure",
    "TransientError", "PreemptionError", "CollectiveTimeoutError",
    "EngineStoppedError", "NumericFault", "arm_emergency_checkpoint",
    "corrupt_checkpoint",
    "run_smoke",
]
