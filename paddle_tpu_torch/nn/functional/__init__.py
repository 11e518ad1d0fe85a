"""paddle_tpu_torch.nn.functional (counterpart of
``paddle_tpu/nn/functional``)."""

from .activation import gelu, silu, swish  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
