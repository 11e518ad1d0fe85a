"""paddle_tpu_torch.nn — the layers and functionals the GPT serving path
uses (counterpart of ``paddle_tpu/nn``)."""

from . import functional  # noqa: F401
from .layers.common import Linear  # noqa: F401
from .layers.norm import LayerNorm  # noqa: F401
