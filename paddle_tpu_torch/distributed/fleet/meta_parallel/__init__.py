"""paddle_tpu_torch.distributed.fleet.meta_parallel: the tensor-parallel
layers and the TP RNG tracker.  Pipeline (``LayerDesc``,
``PipelineLayer``, the schedules), ZeRO sharding, MoE and the sequence /
sep helpers are later parts of ROADMAP Queue 1 item 9."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    ParallelCrossEntropy, is_sharded, parallel_softmax_cross_entropy,
)
from .random_ctrl import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
