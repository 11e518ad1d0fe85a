"""paddle_tpu_torch.distributed.fleet — the distributed façade
(counterpart of ``paddle_tpu/distributed/fleet``).

``fleet.init`` joins the job and builds the hybrid topology
(:class:`~..topology.HybridCommunicateGroup`, one process group per
comm list of every axis); ``distributed_model`` wraps a model in
``DataParallel`` over the dp group when dp > 1 (tensor-parallel layers
already hold their shards); ``distributed_optimizer`` returns the
optimizer unchanged, as the reference's: the gradient reduction lives in
``DataParallel``; a ``PipelineLayer`` at pp > 1 becomes a
``PipelineParallel`` that runs its stages one per rank.
"""

from __future__ import annotations

import warnings

from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from ..topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from .. import env as _env
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401
from .meta_parallel import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    ParallelCrossEntropy, get_rng_state_tracker, model_parallel_random_seed,
    LayerDesc, SharedLayerDesc, PipelineLayer, PipelineParallel,
)
from .utils.recompute import recompute, recompute_sequential  # noqa: F401

_FLEET = {"strategy": None, "initialized": False}

# strategy knobs whose reference implementations change training
# semantics (different optimizer math or gradient flow), not just
# scheduling: inert here as in the reference, so fleet.init warns
_SEMANTIC_INERT_KNOBS = ("localsgd", "dgc", "lamb", "lars", "a_sync",
                         "heter_ccl_mode")


def init(role_maker=None, is_collective=False, strategy=None, log_level="INFO"):
    """``fleet.init``: join the job (``init_parallel_env``, on this rank's
    card unless it was initialized already, e.g. on the CPU) and build the
    hybrid topology.  With every degree 1 and ``is_collective``, dp is the
    world size."""
    _env.init_parallel_env()
    strategy = strategy or DistributedStrategy()
    _FLEET["strategy"] = strategy
    inert_on = [k for k in _SEMANTIC_INERT_KNOBS
                if getattr(strategy, k, False)]
    if inert_on:
        warnings.warn(
            f"DistributedStrategy knobs {inert_on} are accepted for config "
            "parity but have NO effect in this runtime: training semantics "
            "will match plain synchronous SGD/your chosen optimizer, not "
            "the reference's rewritten graph. Unset them or use the "
            "equivalent native feature (e.g. optimizer.Lamb).",
            UserWarning, stacklevel=2)
    hc = strategy.hybrid_configs
    order = list(hc.get("order") or ["dp", "pp", "sharding", "sep", "mp"])
    degrees = {"dp": int(hc.get("dp_degree", 1)), "pp": int(hc.get("pp_degree", 1)),
               "sharding": int(hc.get("sharding_degree", 1)),
               "sep": int(hc.get("sep_degree", 1)), "mp": int(hc.get("mp_degree", 1))}
    want = 1
    for d in degrees.values():
        want *= d
    if want == 1 and is_collective:
        # pure DP over every rank (the reference's collective default)
        degrees["dp"] = _env.get_world_size()
    topo = CommunicateTopology(order, [degrees[a] for a in order])
    set_hybrid_communicate_group(HybridCommunicateGroup(topo))
    _FLEET["initialized"] = True
    return None


def is_initialized():
    return _FLEET["initialized"]


def get_strategy():
    return _FLEET["strategy"]


fleet_strategy = get_strategy


def distributed_model(model):
    """Wrap for the current parallel mode (reference
    ``fleet.distributed_model``, in its branch order): ``DataParallel``
    over the dp group in data / sharding mode; a ``PipelineLayer`` at
    pp > 1 in a ``PipelineParallel``; ``DataParallel`` when dp > 1; else
    the model itself."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        init(is_collective=True)
        hcg = get_hybrid_communicate_group()
    from ..parallel import DataParallel

    if hcg.get_parallel_mode() in ("data", "sharding"):
        return DataParallel(model, group=hcg.get_data_parallel_group())
    if hcg.get_pipe_parallel_world_size() > 1 \
            and isinstance(model, PipelineLayer):
        return PipelineParallel(model, hcg, _FLEET["strategy"])
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """Returns the optimizer unchanged, as the reference's does: the
    gradient reduction lives in ``DataParallel``."""
    return optimizer


# role makers (reference: PaddleCloudRoleMaker): the env contract is read
# by init_parallel_env, so they only record their arguments
class UserDefinedRoleMaker:
    def __init__(self, *a, **k):
        pass


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=False, **kw):
        self._is_collective = is_collective


def worker_index():
    return _env.get_rank()


def worker_num():
    return _env.get_world_size()


def is_first_worker():
    return _env.get_rank() == 0


def barrier_worker():
    from ..communication import barrier

    barrier()
