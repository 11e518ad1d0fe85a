"""``paddle.callbacks`` (counterpart of ``paddle_tpu/callbacks.py``): the
``hapi`` callback classes."""

from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, MetricsLoggerCallback,
    ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau, VisualDL,
    WandbCallback,
)
