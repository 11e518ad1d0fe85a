"""Image transforms (counterpart of ``paddle_tpu/vision/transforms``).

Host-side preprocessing on numpy HWC uint8 / float arrays, in the
``io.DataLoader``'s workers; the consumer moves each collated batch to
the card in one copy.
"""

from .transforms import (  # noqa: F401
    BaseTransform, Compose, ToTensor, Normalize, Transpose, Resize, RandomResizedCrop,
    CenterCrop, RandomCrop, RandomHorizontalFlip, RandomVerticalFlip, Pad,
    BrightnessTransform, ContrastTransform, SaturationTransform, HueTransform,
    ColorJitter, Grayscale, RandomAffine, RandomPerspective, RandomRotation, RandomErasing,
)
from . import functional  # noqa: F401
from .functional import (  # noqa: F401
    to_tensor, normalize, resize, crop, center_crop, hflip, vflip, pad, to_grayscale,
    adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue, affine, perspective, rotate, erase,
)
