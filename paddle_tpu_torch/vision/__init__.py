"""paddle_tpu_torch.vision (counterpart of ``paddle_tpu/vision``): the
model zoo with the detectors (``models``), the host-side ``transforms``
and ``datasets``, the detection ``ops``, and the image-backend switch."""

from . import models  # noqa: F401
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import ops  # noqa: F401
from .models import *  # noqa: F401,F403

_IMAGE_BACKEND = "pil"


def set_image_backend(backend):
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unsupported image backend {backend!r}")
    global _IMAGE_BACKEND
    _IMAGE_BACKEND = backend


def get_image_backend():
    return _IMAGE_BACKEND
