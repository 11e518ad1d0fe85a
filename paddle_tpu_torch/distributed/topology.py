"""Hybrid-parallel topology (counterpart of ``paddle_tpu/distributed/topology.py``).

:class:`CommunicateTopology` factors the world into the axes (dp, pp,
sharding, sep, mp), outer to inner: pure index arithmetic, a copy of the
reference's.  :class:`HybridCommunicateGroup` builds one
:class:`~.collective.Group` per comm list of every axis, on every rank,
in one fixed order (``torch.distributed.new_group`` is collective), and
keeps the ones this process is in.  Each rank is a process of its own,
so the rank getters return this process's real coordinate on each axis.

At pp > 1 it also builds the pipeline's stage-pair groups: for every pp
comm list, one two-rank group per pair of neighbouring stages (s, s + 1)
and, beyond two stages, the wrap pair (S - 1, 0) that the interleaved
schedule hops over between laps.  A hop between two stages is a
``broadcast`` from the sender in their pair's group, so the same code
path runs over gloo on the CPU, gloo on one card and NCCL between cards.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch.distributed as dist

# canonical outer→inner axis order (reference order: dp, pp, sharding, sep, mp)
AXES = ("dp", "pp", "sharding", "sep", "mp")


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        names = list(hybrid_group_names or AXES)
        dims = list(dims or [1] * len(names))
        self._names = names
        self._dims = dims
        self._world = int(np.prod(dims))

    def get_hybrid_group_names(self):
        return list(self._names)

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kw):
        idx = [kw.get(n, 0) for n in self._names]
        return int(np.ravel_multi_index(idx, self._dims))

    def get_coord(self, rank):
        return dict(zip(self._names, np.unravel_index(rank, self._dims)))

    def get_axis_list(self, axis_name, index):
        coords = np.array(np.unravel_index(np.arange(self._world), self._dims)).T
        ax = self._names.index(axis_name)
        return [int(r) for r, c in enumerate(coords) if c[ax] == index]

    def get_comm_list(self, axis_name):
        """All groups along axis_name: list of rank-lists varying that axis."""
        ax = self._names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != ax]
        groups = []
        for flat in range(int(np.prod(other_dims)) if other_dims else 1):
            fixed = list(np.unravel_index(flat, other_dims)) if other_dims else []
            ranks = []
            for k in range(self._dims[ax]):
                idx = fixed[:ax] + [k] + fixed[ax:]
                ranks.append(int(np.ravel_multi_index(idx, self._dims)))
            groups.append(ranks)
        return groups


class HybridCommunicateGroup:
    """fleet's hcg over ``torch.distributed``: needs a default process
    group whose world size is the topology's (``init_parallel_env``).

    ``get_*_parallel_group()`` return the :class:`~.collective.Group` of
    this process on that axis; the TP layers, ``DataParallel`` and the
    global-norm clip run their collectives over them."""

    def __init__(self, topology: CommunicateTopology):
        from . import collective

        self._topo = topology
        dims = OrderedDict((n, topology.get_dim(n))
                           for n in topology.get_hybrid_group_names())
        world = collective.get_default_group().nranks
        if topology.world_size() != world:
            raise ValueError(
                f"hybrid topology {dict(dims)} wants {topology.world_size()} "
                f"ranks; the job has {world} (PADDLE_TRAINERS_NUM)")
        self._dims = dims
        self._rank = dist.get_rank()
        self._coord = {k: int(v)
                       for k, v in topology.get_coord(self._rank).items()}
        # every rank creates every group, in this order (new_group is
        # collective); each keeps the one it is in
        self._groups = {}
        self._group_ids = []
        for name in dims:
            for ranks in topology.get_comm_list(name):
                g = collective.new_group(ranks, axis_name=name)
                self._group_ids.append(g.id)
                if self._rank in ranks:
                    self._groups[name] = g
        # the stage-pair groups of every pp comm list, also collective
        self._pp_pairs = {}
        if dims.get("pp", 1) > 1:
            for ranks in topology.get_comm_list("pp"):
                S = len(ranks)
                pairs = [(ranks[i], ranks[i + 1]) for i in range(S - 1)]
                if S > 2:
                    pairs.append((ranks[S - 1], ranks[0]))
                mine = {}
                for i, pair in enumerate(pairs):
                    g = collective.new_group(list(pair), axis_name="pp_pair")
                    self._group_ids.append(g.id)
                    mine[i] = g
                if S == 2:      # the wrap pair (1, 0) is the pair (0, 1)
                    mine[1] = mine[0]
                if self._rank in ranks:
                    self._pp_pairs = mine

    # degrees
    def get_data_parallel_world_size(self):
        return self._dims.get("dp", 1)

    def get_model_parallel_world_size(self):
        return self._dims.get("mp", 1)

    def get_pipe_parallel_world_size(self):
        return self._dims.get("pp", 1)

    def get_sharding_parallel_world_size(self):
        return self._dims.get("sharding", 1)

    def get_sep_parallel_world_size(self):
        return self._dims.get("sep", 1)

    # ranks: this process's coordinate on each axis
    def _axis_rank(self, name):
        return self._coord.get(name, 0)

    def get_data_parallel_rank(self):
        return self._axis_rank("dp")

    def get_model_parallel_rank(self):
        return self._axis_rank("mp")

    def get_stage_id(self):
        return self._axis_rank("pp")

    # pipeline stages
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def _stage_rank(self, stage):
        g = self._groups.get("pp")
        S = self.get_pipe_parallel_world_size()
        return g.ranks[stage % S] if g is not None else self._rank

    def get_prev_stage_rank(self):
        """The global rank of the previous stage in this process's pp
        group (stage S - 1 for stage 0, the interleaved schedule's wrap)."""
        return self._stage_rank(self.get_stage_id() - 1)

    def get_next_stage_rank(self):
        """The global rank of the next stage in this process's pp group
        (stage 0 for stage S - 1)."""
        return self._stage_rank(self.get_stage_id() + 1)

    def get_stage_pair_group(self, pair):
        """The two-rank group of stages (``pair``, ``pair + 1``) of this
        process's pp group; ``pair = S - 1`` is the wrap pair (S - 1, 0).
        None outside the pair or at pp = 1."""
        g = self._pp_pairs.get(pair % max(self.get_pipe_parallel_world_size(),
                                          1))
        return g if g is not None and g.is_member() else None

    def get_sharding_parallel_rank(self):
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self):
        return self._axis_rank("sep")

    def get_global_rank(self):
        return self._rank

    # groups
    def get_data_parallel_group(self):
        return self._groups.get("dp")

    def get_model_parallel_group(self):
        return self._groups.get("mp")

    def get_pipe_parallel_group(self):
        return self._groups.get("pp")

    def get_sharding_parallel_group(self):
        return self._groups.get("sharding")

    def get_sep_parallel_group(self):
        return self._groups.get("sep")

    def get_check_parallel_group(self, *a, **k):
        return self._groups.get("mp")

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0] if "dp" in self._groups else 0

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0] if "mp" in self._groups else 0

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._dims.get("mp", 1) > 1 or self._dims.get("pp", 1) > 1:
            return "hybrid"
        if self._dims.get("sharding", 1) > 1:
            return "sharding"
        if self._dims.get("dp", 1) > 1:
            return "data"
        return "single"


_HCG = [None]


def set_hybrid_communicate_group(hcg):
    prev = _HCG[0]
    if prev is not None and prev is not hcg:
        # unregister the replaced hcg's groups so repeated fleet.init in
        # one process does not grow the registry
        from . import collective

        for gid in prev._group_ids:
            collective._GROUPS.pop(gid, None)
        collective._gauge_groups()
    _HCG[0] = hcg


def get_hybrid_communicate_group():
    return _HCG[0]


def pipe_parallel_group():
    """The hybrid topology's pp group when its degree is > 1, else None
    (no pipeline)."""
    hcg = _HCG[0]
    if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
        return hcg.get_pipe_parallel_group()
    return None


def model_parallel_group():
    """The hybrid topology's model-parallel group when its degree is > 1
    (``fleet.init`` with ``mp_degree``), else None (no tensor
    parallelism)."""
    hcg = _HCG[0]
    if hcg is not None and hcg.get_model_parallel_world_size() > 1:
        return hcg.get_model_parallel_group()
    return None
