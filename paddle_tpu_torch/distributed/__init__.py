"""paddle_tpu_torch.distributed (counterpart of ``paddle_tpu/distributed``):
process groups and the eager collectives over ``torch.distributed``, the
process environment, ``DataParallel`` and ``spawn``, the hybrid topology,
``fleet`` with the tensor-parallel layers and the pipeline, and the
launcher.  One process per rank (NCCL between cards, gloo on the CPU), as
upstream Paddle runs on GPUs; the reference is single-controller.  The
serving mesh is ``serving.ServingEngine(mesh=...)`` (``serving/mesh.py``).
ZeRO, sequence and sep parallelism, MoE, ring attention,
``auto_parallel``, ``elastic`` and the orbax checkpoints are later parts
of ROADMAP Queue 1 item 9.
"""

from .env import (  # noqa: F401
    init_parallel_env, is_initialized, get_rank, get_world_size, ParallelEnv,
)
from .collective import (  # noqa: F401
    Group, ReduceOp, new_group, get_group, get_default_group,
    destroy_process_group, is_available,
)
from .communication import (  # noqa: F401
    all_reduce, all_gather, all_gather_object, reduce, reduce_scatter,
    broadcast, scatter, alltoall, alltoall_single, send, recv, isend, irecv,
    barrier, stream,
)
from .parallel import DataParallel, spawn  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from . import fleet  # noqa: F401

import importlib as _importlib

_LAZY = ("launch",)


def __getattr__(name):
    if name in _LAZY:
        mod = _importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch.distributed' has no attribute {name!r}")


def get_backend():
    """The default group's backend (``"nccl"`` / ``"gloo"``), None before
    ``init_parallel_env``."""
    from . import env

    return env.backend()


def parallel_device_count():
    import torch

    return torch.cuda.device_count()
