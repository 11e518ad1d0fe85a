"""paddle_tpu_torch.vision (counterpart of ``paddle_tpu/vision``): the
classification zoo (``models``) and the image-backend switch.  The
transforms, datasets, detection ops and detection models are not ported
yet (ROADMAP Queue 1 item 8)."""

from . import models  # noqa: F401
from .models import *  # noqa: F401,F403

_IMAGE_BACKEND = "pil"


def set_image_backend(backend):
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unsupported image backend {backend!r}")
    global _IMAGE_BACKEND
    _IMAGE_BACKEND = backend


def get_image_backend():
    return _IMAGE_BACKEND
