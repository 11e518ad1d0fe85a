"""Communication groups (counterpart of ``paddle_tpu/distributed/collective.py``).

The reference is single-controller: a ``Group`` there is a 1-D device
mesh that one process drives.  Here every rank is a process of its own
(``torch.distributed``: NCCL between cards, gloo on the CPU), as upstream
Paddle runs on GPUs, so a :class:`Group` wraps a ``torch.distributed``
process group over its global ranks and :attr:`Group.rank` is this
process's index in it (-1 outside it).

``torch.distributed.new_group`` is itself collective: every rank must call
:func:`new_group` for every group, in the same order, including the
groups it is not in.
"""

from __future__ import annotations

import torch.distributed as dist

_GROUPS: dict[int, "Group"] = {}
_NEXT_GID = [0]


def _gauge_groups():
    from ..profiler import metrics as _metrics

    _metrics.get_registry().gauge(
        "collective.groups_active",
        "live communication groups in the registry").set(len(_GROUPS))


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Group:
    """A collective group over the global ranks ``ranks``.

    ``pg`` is the ``torch.distributed`` process group (None for the
    default group, the whole world); on a rank outside ``ranks`` it is
    ``GroupMember.NON_GROUP_MEMBER`` and :attr:`rank` is -1."""

    def __init__(self, ranks, gid, pg=None, axis_name="g"):
        self.ranks = list(ranks)
        self.id = gid
        self.axis_name = axis_name
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        return self.get_group_rank(dist.get_rank())

    @property
    def process_group(self):
        return self.pg

    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __deepcopy__(self, memo):
        # a handle on a process-wide communicator: a copied model (a
        # tensor-parallel layer holds its group) shares it
        return self

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, axis={self.axis_name!r})"


def _ensure_default_group() -> Group:
    if 0 not in _GROUPS:
        from .env import init_parallel_env

        if not dist.is_initialized():
            init_parallel_env()
        _GROUPS[0] = Group(range(dist.get_world_size()), 0, None,
                           axis_name="world")
    return _GROUPS[0]


def get_default_group() -> Group:
    return _ensure_default_group()


def get_group(gid: int = 0) -> Group:
    if gid not in _GROUPS:
        if gid == 0:
            return _ensure_default_group()
        raise ValueError(f"no group with id {gid}")
    return _GROUPS[gid]


def new_group(ranks=None, backend=None, timeout=None, axis_name=None) -> Group:
    """``paddle.distributed.new_group``: a group over the global ``ranks``
    (every rank by default).  Collective: every rank calls it, in the same
    order, for every group."""
    world = _ensure_default_group()
    ranks = list(world.ranks if ranks is None else ranks)
    kw = {"timeout": timeout} if timeout is not None else {}
    pg = dist.new_group(ranks, backend=backend, **kw)
    _NEXT_GID[0] += 1
    gid = _NEXT_GID[0]
    g = Group(ranks, gid, pg, axis_name=axis_name or f"g{gid}")
    _GROUPS[gid] = g
    from ..profiler import metrics as _metrics

    _metrics.get_registry().counter(
        "collective.groups_created", "new_group() calls").inc(
        nranks=g.nranks)
    _gauge_groups()
    return g


def destroy_process_group(group=None):
    """Drop ``group`` (every group, and the default process group with
    them, when None).  Ids are never reused."""
    if group is None:
        _GROUPS.clear()
        from . import env as _env

        _env._shutdown()
    else:
        _GROUPS.pop(group.id, None)
        if group.pg is not None and group.is_member() \
                and group.pg is not dist.GroupMember.NON_GROUP_MEMBER:
            dist.destroy_process_group(group.pg)
    _gauge_groups()


def is_available() -> bool:
    return dist.is_available()
