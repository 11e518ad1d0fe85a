"""paddle_tpu_torch.text.models (counterpart of ``paddle_tpu/text/models``)."""

from .convert import (export_paddle_tpu_state_dict,  # noqa: F401
                      load_paddle_tpu_state_dict)
from .gpt import GPTDecoderLayer, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
