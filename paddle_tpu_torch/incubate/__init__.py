"""paddle_tpu_torch.incubate (counterpart of ``paddle_tpu/incubate``): the
optimizer wrappers :class:`LookAhead`, :class:`ExponentialMovingAverage`
and :class:`ModelAverage`."""

from . import optimizer  # noqa: F401
from .optimizer import ExponentialMovingAverage, LookAhead, ModelAverage  # noqa: F401
