"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``).

Each clip is a callable over ``[(param, grad)]`` pairs returning new pairs;
a parameter with ``need_clip = False`` keeps its gradient.  The optimizers
call it once per parameter group in ``step()``; ``jit.TrainStep`` calls it
once over every gradient, as the TPU package's ``tree_clip`` does.
"""

from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _clipped(p):
    return getattr(p, "need_clip", True)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip_one(self, g):
        norm = torch.linalg.vector_norm(g)
        scale = torch.where(norm > self.clip_norm, self.clip_norm / norm,
                            torch.ones_like(norm))
        return g * scale

    def __call__(self, params_grads):
        return [(p, self._clip_one(g) if _clipped(p) else g)
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / (global_norm + 1e-6), 1)``,
    the global norm taken in f32 over all clipped gradients.

    Under a hybrid topology with mp > 1 or pp > 1 the norm is the full
    logical model's, as the reference's (one program over the full
    parameters) is: the squares of the mp-sharded gradients
    (``is_distributed``) are summed over the mp group, and each
    replicated one (the LayerNorms, the row-parallel biases, the position
    embedding) counts once; under pp the squares are summed over the pp
    group, each parameter's divided by the number of stages holding a
    copy (``pp_holders``: 1 for a stage's blocks, every stage for the
    embeddings, the final LayerNorm and any unmarked parameter), so a
    replica counts once.  The dp gradients are already reduced, so no dp
    term is needed."""

    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = clip_norm

    def _global_norm(self, params_grads):
        """The f32 norm over the clipped gradients of ``params_grads``
        (None when there is none)."""
        gs = [(p, g) for p, g in params_grads if _clipped(p)]
        if not gs:
            return None
        sq = [torch.sum(torch.square(g.float())) for _, g in gs]
        from ..distributed.topology import (model_parallel_group,
                                            pipe_parallel_group)

        group = model_parallel_group()
        pp = pipe_parallel_group()
        if pp is not None:
            from ..distributed.communication import all_reduce
            from ..distributed.fleet.meta_parallel.mp_layers import is_sharded

            zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
            share = [s / vars(p).get("pp_holders", pp.nranks)
                     for (p, _), s in zip(gs, sq)]
            sharded = sum((s for (p, _), s in zip(gs, share)
                           if is_sharded(p)), zero)
            if group is not None:
                sharded = all_reduce(sharded, group=group)
            replicated = sum((s for (p, _), s in zip(gs, share)
                              if not is_sharded(p)), zero)
            global_norm = torch.sqrt(all_reduce(sharded + replicated,
                                                group=pp))
        elif group is None:
            global_norm = torch.sqrt(sum(sq))
        else:
            from ..distributed.communication import all_reduce
            from ..distributed.fleet.meta_parallel.mp_layers import is_sharded

            zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
            sharded = sum((s for (p, _), s in zip(gs, sq)
                           if is_sharded(p)), zero)
            replicated = sum((s for (p, _), s in zip(gs, sq)
                              if not is_sharded(p)), zero)
            global_norm = torch.sqrt(replicated + all_reduce(sharded,
                                                             group=group))
        return global_norm

    def __call__(self, params_grads):
        global_norm = self._global_norm(params_grads)
        if global_norm is None:
            return params_grads
        scale = torch.clamp(self.clip_norm / (global_norm + 1e-6), max=1.0)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p) else g)
                for p, g in params_grads]
