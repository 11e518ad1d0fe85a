"""Recovery supervisor: close the loop from detected failure to resumed
training (counterpart of ``paddle_tpu/resilience/supervisor.py``).

Over a bare restart loop, this supervisor adds:

- **failure classification** (:func:`.retry.classify_failure`) — transient
  failures (preemption, collective timeout) burn a restart budget with
  capped, jittered exponential backoff; fatal ones (program errors)
  surface immediately by default; numeric faults roll back on a budget of
  their own;
- **valid-checkpoint resume** — restore walks back over corrupt
  checkpoints (checksum manifests, :class:`.checkpoint
  .AsyncCheckpointManager.restore_latest_valid`) instead of crashing again
  on a half-written or bit-flipped newest step;
- **metrics** — ``resilience.restarts{kind=,supervisor=}`` and
  ``resilience.backoff_seconds`` land in the port's registry so a
  dashboard shows a job that is *surviving* failures before anyone greps
  logs.
"""

from __future__ import annotations

import logging
import time

from ..profiler import metrics as _metrics
from .retry import RetryPolicy, classify_failure

logger = logging.getLogger("paddle_tpu_torch.resilience")


def restart_metrics():
    """The (counter, histogram) pair every supervisor emits through."""
    return (_metrics.counter("resilience.restarts",
                             "supervisor restarts by failure kind"),
            _metrics.histogram("resilience.backoff_seconds",
                               "backoff slept before each restart"))


class RecoverySupervisor:
    """Run a resumable ``train_fn(start_step, state)`` with classified
    restart-on-failure over an :class:`~.checkpoint.AsyncCheckpointManager`.

    ``train_fn`` receives the step to resume from (0 on a fresh start) and
    the restored state (None on a fresh start); it should checkpoint
    through the same manager.  On a transient failure the supervisor backs
    off (jittered exponential, capped), reloads the newest *valid*
    checkpoint — falling back past corrupt ones — and calls it again.
    ``to_tensors`` / ``device`` are passed to the restore: tensors on
    ``device`` (None: the card), or numpy with ``to_tensors=False``.
    """

    def __init__(self, manager, policy=None, max_transient_restarts=5,
                 max_fatal_restarts=0, max_numeric_restarts=2,
                 on_restart=None, to_tensors=True, device=None):
        self.manager = manager
        self.policy = policy if policy is not None \
            else RetryPolicy(base_delay=1.0, max_delay=30.0, jitter=0.5)
        self.max_transient_restarts = int(max_transient_restarts)
        self.max_fatal_restarts = int(max_fatal_restarts)
        # NumericFault: a poisoned step is not transient (a blind retry of
        # the same step replays the NaN) but rollback to the last VALID
        # checkpoint usually is recoverable — its own small budget
        self.max_numeric_restarts = int(max_numeric_restarts)
        self.on_restart = on_restart   # fn(kind, exc, attempt) — test hook
        self.to_tensors = to_tensors
        self.device = device
        self.restarts = {"transient": 0, "fatal": 0}
        self._m_restarts, self._m_backoff = restart_metrics()

    def run(self, train_fn):
        while True:
            try:
                # drain the crashed run's still-queued async saves BEFORE
                # choosing the resume point: a save committing after the
                # restore would plant a newer checkpoint from the abandoned
                # timeline, and a later failure would resume past the
                # segment just retrained (non-monotonic resume)
                if hasattr(self.manager, "wait_until_finished"):
                    try:
                        self.manager.wait_until_finished()
                    except Exception:
                        pass  # writer failure: restore falls back anyway
                step, state = self.manager.restore_latest_valid(
                    to_tensors=self.to_tensors, device=self.device)
                return train_fn(int(step) if step is not None else 0, state)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                kind = classify_failure(e)
                # "numeric" appears lazily so call sites that compare the
                # dict literally keep seeing {transient, fatal}
                self.restarts[kind] = self.restarts.get(kind, 0) + 1
                budget = {"transient": self.max_transient_restarts,
                          "numeric": self.max_numeric_restarts,
                          }.get(kind, self.max_fatal_restarts)
                if self.restarts[kind] > budget:
                    logger.error(
                        "[resilience] %s failure #%d exceeds budget %d; "
                        "surfacing", kind, self.restarts[kind], budget)
                    raise
                attempt = sum(self.restarts.values())
                delay = self.policy.delay(attempt)
                self._m_restarts.inc(kind=kind, supervisor="recovery")
                self._m_backoff.observe(delay)
                logger.warning(
                    "[resilience] %s failure (%r): restart %d/%d after "
                    "%.2fs backoff, resuming from latest valid checkpoint",
                    kind, e, self.restarts[kind], budget, delay)
                if self.on_restart is not None:
                    self.on_restart(kind, e, attempt)
                time.sleep(delay)
