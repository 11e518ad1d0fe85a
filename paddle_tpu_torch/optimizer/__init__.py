"""paddle_tpu_torch.optimizer (counterpart of ``paddle_tpu/optimizer``)."""

from . import lr  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam,  # noqa: F401
                        Adamax, AdamW, Lamb, Lars, Momentum, NAdam, Optimizer,
                        RAdam, RMSProp, Rprop)
