"""paddle_tpu_torch.hapi — the high-level ``Model`` API (counterpart of
``paddle_tpu/hapi``)."""

from .model import Model  # noqa: F401
from .model_summary import summary, flops  # noqa: F401
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, MetricsLoggerCallback, ProgBarLogger, ModelCheckpoint,
    EarlyStopping, VisualDL,
)
