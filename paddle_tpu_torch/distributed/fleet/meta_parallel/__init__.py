"""paddle_tpu_torch.distributed.fleet.meta_parallel: the tensor-parallel
layers, the TP RNG tracker and the pipeline (``LayerDesc``,
``PipelineLayer``, ``PipelineParallel`` and the schedules).  ZeRO
sharding, MoE and the sequence / sep helpers are a later part of ROADMAP
Queue 1 item 9."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    ParallelCrossEntropy, is_sharded, parallel_softmax_cross_entropy,
    sharded_vocab_head_loss,
)
from .pp_layers import (  # noqa: F401
    LayerDesc, SharedLayerDesc, PipelineLayer, PipelineParallel,
)
from .random_ctrl import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .pipeline_schedule import (  # noqa: F401
    spmd_pipeline, spmd_pipeline_1f1b, pipeline_tick_stats)
