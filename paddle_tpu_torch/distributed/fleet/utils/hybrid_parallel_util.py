"""Hybrid-parallel gradient utilities (counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``): the
helpers a hand-written hybrid loop calls between ``backward()`` and
``step()``.  Each rank is a process of its own, so these are real
collectives over the hybrid topology's groups, bucketed into one flat
buffer per dtype (``parallel.mean_reduce_`` / ``broadcast_``).
"""

from __future__ import annotations

from ...parallel import broadcast_, mean_reduce_
from ...topology import get_hybrid_communicate_group


def _resolve_hcg(hcg):
    return hcg if hcg is not None else get_hybrid_communicate_group()


def fused_allreduce_gradients(parameter_list, hcg=None):
    """Mean-reduce every parameter's gradient over the dp group (a no-op
    without a topology or at dp 1).  A tensor-parallel gradient stays on
    its shard: only the dp axis is reduced."""
    hcg = _resolve_hcg(hcg)
    if hcg is None or hcg.get_data_parallel_world_size() <= 1:
        return
    grads = [p.grad for p in parameter_list
             if getattr(p, "grad", None) is not None]
    if grads:
        mean_reduce_(grads, hcg.get_data_parallel_group())


def sharding_reduce_gradients(parameter_list, hcg=None):
    """The reference delegates to the dp mean-reduce; so does this."""
    fused_allreduce_gradients(parameter_list, hcg)


def broadcast_dp_parameters(model, hcg=None):
    """Every dp rank starts from the dp group's first rank's parameters."""
    hcg = _resolve_hcg(hcg)
    if hcg is None or hcg.get_data_parallel_world_size() <= 1:
        return
    g = hcg.get_data_parallel_group()
    broadcast_(list(model.parameters()), g.ranks[0], g)


def broadcast_mp_parameters(model, hcg=None):
    """Every mp rank starts from the mp group's first rank's replicated
    parameters (a sharded one, ``is_distributed``, keeps its shard)."""
    hcg = _resolve_hcg(hcg)
    if hcg is None or hcg.get_model_parallel_world_size() <= 1:
        return
    from ..meta_parallel.mp_layers import is_sharded

    g = hcg.get_model_parallel_group()
    params = [p for p in model.parameters() if not is_sharded(p)]
    if params:
        broadcast_(params, g.ranks[0], g)


def broadcast_input_data(hcg, *inputs):
    """Every mp rank sees the mp group's first rank's batch: each tensor
    input is broadcast over the mp group in place.  Returns the inputs
    (one input as itself)."""
    hcg = _resolve_hcg(hcg)
    if hcg is not None and hcg.get_model_parallel_world_size() > 1:
        from ...communication import broadcast

        g = hcg.get_model_parallel_group()
        for x in inputs:
            if hasattr(x, "is_cuda"):
                broadcast(x, src=g.ranks[0], group=g)
    return inputs if len(inputs) != 1 else inputs[0]
