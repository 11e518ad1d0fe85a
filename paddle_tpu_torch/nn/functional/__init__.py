"""paddle_tpu_torch.nn.functional (counterpart of
``paddle_tpu/nn/functional``)."""

from .activation import (celu, elu, gelu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout, mish,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid, silu,
                         softmax, softmax_, softplus, softshrink, softsign,
                         swish, tanh, tanhshrink, thresholded_relu)
from .attention import (flash_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import (affine_grid, alpha_dropout, bilinear,  # noqa: F401
                     channel_shuffle, cosine_similarity, dropout, dropout2d,
                     dropout3d, embedding, fold, grid_sample, interpolate,
                     label_smooth, linear, one_hot, pad, pairwise_distance,
                     pixel_shuffle, pixel_unshuffle, sequence_mask, unfold,
                     upsample)
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import cross_entropy  # noqa: F401
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, normalize, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d,
                      fractional_max_pool3d, lp_pool1d, lp_pool2d,
                      max_pool1d, max_pool2d, max_pool3d, max_unpool1d,
                      max_unpool2d, max_unpool3d)
