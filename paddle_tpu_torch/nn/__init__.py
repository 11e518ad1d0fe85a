"""paddle_tpu_torch.nn — the layers and functionals of the ported models
(counterpart of ``paddle_tpu/nn``): the containers, linear / embedding /
dropout, the transformer layers, and the vision half (convolutions,
pooling, the norms, the activation layers, resampling and the other
common layers), with ``ParamAttr``."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
# the grad-clip classes, importable from paddle.nn as in the reference
from ..optimizer.clip import (ClipGradByGlobalNorm,  # noqa: F401
                              ClipGradByNorm, ClipGradByValue)
from .layer import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .layers.activation import (CELU, ELU, GELU, GLU, SELU,  # noqa: F401
                                Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
                                LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                                Mish, PReLU, ReLU, ReLU6, RReLU, Sigmoid,
                                Silu, Softmax, Softmax2D, Softplus,
                                Softshrink, Softsign, Swish, Tanh,
                                Tanhshrink, ThresholdedReLU)
from .layers.common import (AlphaDropout, Bilinear,  # noqa: F401
                            ChannelShuffle, CosineSimilarity, Dropout,
                            Dropout1D, Dropout2D, Dropout3D, Embedding,
                            FeatureAlphaDropout, Flatten, Fold, Identity,
                            Linear, Pad1D, Pad2D, Pad3D, PairwiseDistance,
                            PixelShuffle, PixelUnshuffle, Unflatten, Unfold,
                            Upsample, UpsamplingBilinear2D,
                            UpsamplingNearest2D, ZeroPad1D, ZeroPad2D,
                            ZeroPad3D)
from .layers.conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                          Conv2DTranspose, Conv3D, Conv3DTranspose)
from .layers.loss import CrossEntropyLoss  # noqa: F401
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                          BatchNorm3D, GroupNorm, InstanceNorm1D,
                          InstanceNorm2D, InstanceNorm3D, LayerNorm,
                          LocalResponseNorm, RMSNorm, SpectralNorm,
                          SyncBatchNorm)
from .layers.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                             AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                             AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                             AvgPool2D, AvgPool3D, FractionalMaxPool2D,
                             FractionalMaxPool3D, LPPool1D, LPPool2D,
                             MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
                             MaxUnPool2D, MaxUnPool3D)
from .layers.transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)
from .param_attr import L1Decay, L2Decay, ParamAttr  # noqa: F401
from . import utils  # noqa: F401
