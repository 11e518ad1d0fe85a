"""paddle_tpu_torch.resilience — failure classification and retry backoff
(counterpart of ``paddle_tpu/resilience``, its :mod:`.retry` module; the
serving engine's restart path is its consumer)."""

from .retry import (  # noqa: F401
    CollectiveTimeoutError, EngineStoppedError, NumericFault, PreemptionError,
    RetryPolicy, TransientError, classify_failure, derive_seed,
)
