"""paddle_tpu_torch.distributed.fleet: activation recomputation
(``fleet.recompute``, ``recompute_sequential``), as
``paddle_tpu.distributed.fleet`` exports it.  Nothing else of ``fleet``
is ported yet (ROADMAP Queue 1 item 9)."""

from . import utils  # noqa: F401
from .utils.recompute import recompute, recompute_sequential  # noqa: F401
