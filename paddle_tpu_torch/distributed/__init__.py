"""paddle_tpu_torch.distributed (counterpart of ``paddle_tpu/distributed``):
so far only ``fleet.recompute``; the rest of ``distributed`` (process
groups, collectives, meshes, ``fleet.init``) waits for ROADMAP Queue 1
item 9."""

from . import fleet  # noqa: F401
