"""paddle_tpu_torch.nn — the layers and functionals the GPT, Llama and
BERT paths use (counterpart of ``paddle_tpu/nn``)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layers.common import Dropout, Embedding, Linear  # noqa: F401
from .layers.loss import CrossEntropyLoss  # noqa: F401
from .layers.norm import LayerNorm, RMSNorm, SpectralNorm  # noqa: F401
from .layers.transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)
from . import utils  # noqa: F401
