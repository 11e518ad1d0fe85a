"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``, copied).

They read only local files that the caller names: ``download=True``
raises, as in the reference, and nothing is fetched.  ``DatasetFolder`` /
``ImageFolder`` work on any local directory tree.  Samples are numpy
(HWC uint8 images), for ``vision.transforms`` and ``io.DataLoader``.
"""

from .folder import DatasetFolder, ImageFolder  # noqa: F401
from .mnist import MNIST, FashionMNIST  # noqa: F401
from .cifar import Cifar10, Cifar100  # noqa: F401
from .flowers import Flowers  # noqa: F401
from .voc import VOC2012  # noqa: F401

__all__ = ["DatasetFolder", "ImageFolder", "MNIST", "FashionMNIST", "Cifar10",
           "Cifar100", "Flowers", "VOC2012"]
