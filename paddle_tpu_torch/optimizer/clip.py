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
    the global norm taken in f32 over all clipped gradients."""

    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        gs = [g for p, g in params_grads if _clipped(p)]
        if not gs:
            return params_grads
        global_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
        scale = torch.clamp(self.clip_norm / (global_norm + 1e-6), max=1.0)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p) else g)
                for p, g in params_grads]
