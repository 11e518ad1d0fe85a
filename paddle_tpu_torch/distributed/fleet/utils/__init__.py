"""paddle_tpu_torch.distributed.fleet.utils: ``recompute``."""

from . import recompute as recompute_mod  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
