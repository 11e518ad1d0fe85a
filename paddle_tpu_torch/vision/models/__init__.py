"""The model zoo (counterpart of ``paddle_tpu/vision/models/__init__.py``):
the classification nets and the detectors (``YOLOv3``, ``FasterRCNN``,
``ResNetBackbone``, ``FPN`` and the ``yolov3`` / ``ppyoloe`` /
``faster_rcnn`` constructors; ``PPYOLOE`` and the CSPRepResNet parts live
in ``detection`` and ``cspresnet``)."""

from .resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock,
    resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, wide_resnet50_2, wide_resnet101_2,
)
from .lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, MobileNetV3Small, MobileNetV3Large,
    mobilenet_v1, mobilenet_v2, mobilenet_v3_small, mobilenet_v3_large,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33, shufflenet_v2_x0_5,
    shufflenet_v2_x1_0, shufflenet_v2_x1_5, shufflenet_v2_x2_0, shufflenet_v2_swish,
)
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201, densenet264,
)
from .vision_transformer import (  # noqa: F401
    VisionTransformer, vit_b_16, vit_b_32, vit_l_16, vit_s_16,
)
from .inception import (  # noqa: F401
    GoogLeNet, InceptionV3, googlenet, inception_v3,
)
from .detection import (  # noqa: F401
    YOLOv3, FasterRCNN, ResNetBackbone, FPN, yolov3, ppyoloe, faster_rcnn,
)

__all__ = [n for n in dir() if not n.startswith("_")]
