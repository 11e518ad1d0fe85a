"""paddle_tpu_torch.ops — the hand-written Hopper kernels and their
wrappers (counterpart of ``paddle_tpu/ops``).

The submodules ``flash_attention`` and ``paged_attention`` keep their
names here (each carries its kernel's ``LAUNCHES`` counter), so the
functions of the same name are not re-exported: call
``ops.paged_attention.paged_attention``.
"""

from . import flash_attention, paged_attention  # noqa: F401
from .flash_attention import (flash_attention_bshd, flash_attention_fn,  # noqa: F401
                              flash_attention_ref)
from .paged_attention import (paged_attention_ref,  # noqa: F401
                              paged_table_prefill_write,
                              paged_table_token_write)
