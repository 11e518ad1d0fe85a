"""``paddle.amp.debugging`` facade (counterpart of
``paddle_tpu/amp/debugging.py``).

The reference toolkit — ``TensorCheckerConfig`` / ``enable_tensor_checker``
/ ``check_numerics`` / ``collect_operator_stats`` — re-exported over
:mod:`paddle_tpu_torch.observability.numerics`, whose probes also run
inside a probed ``jit.TrainStep``.

Quick use::

    from paddle_tpu_torch.amp import debugging as amp_dbg

    amp_dbg.enable_tensor_checker(
        amp_dbg.TensorCheckerConfig(level="dump", include=("layers",)))
    amp_dbg.check_numerics(loss, "loss")        # warn | dump | abort

    with amp_dbg.collect_operator_stats(model) as col:
        model(x)
    print(col.report())
"""

from __future__ import annotations

from ..observability.numerics import (  # noqa: F401
    STAT_FIELDS, OperatorStatsCollector, TensorCheckerConfig,
    check_numerics, collect_operator_stats, disable_tensor_checker,
    enable_tensor_checker, tensor_stats,
)

# reference-spelled aliases
enable_operator_stats_collection = collect_operator_stats

__all__ = [
    "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "check_numerics", "collect_operator_stats",
    "enable_operator_stats_collection", "OperatorStatsCollector",
    "tensor_stats", "STAT_FIELDS",
]
