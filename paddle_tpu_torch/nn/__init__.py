"""paddle_tpu_torch.nn — the layers and functionals the GPT and Llama
serving and training paths use (counterpart of ``paddle_tpu/nn``)."""

from . import functional  # noqa: F401
from .layers.common import Linear  # noqa: F401
from .layers.loss import CrossEntropyLoss  # noqa: F401
from .layers.norm import LayerNorm, RMSNorm  # noqa: F401
