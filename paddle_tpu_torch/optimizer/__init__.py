"""paddle_tpu_torch.optimizer (counterpart of ``paddle_tpu/optimizer``)."""

from . import lr  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
