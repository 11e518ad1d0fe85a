"""paddle_tpu_torch.distributed.fleet.utils: ``recompute`` and the
hybrid-parallel gradient helpers."""

from . import recompute as recompute_mod  # noqa: F401
from . import hybrid_parallel_util  # noqa: F401
from .hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_input_data, broadcast_mp_parameters,
    fused_allreduce_gradients, sharding_reduce_gradients,
)
from .recompute import recompute, recompute_sequential  # noqa: F401
