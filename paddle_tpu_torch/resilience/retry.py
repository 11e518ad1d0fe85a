"""Error classes of the serving path (copied from
``paddle_tpu/resilience/retry.py``; the retry and restart machinery there
waits for a later slice)."""


class EngineStoppedError(RuntimeError):
    """A serving request failed because its engine was stopped with the
    request still in flight (``ServingEngine.stop()`` without drain)."""
