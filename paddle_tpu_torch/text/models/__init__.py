"""paddle_tpu_torch.text.models (counterpart of ``paddle_tpu/text/models``)."""

from .bert import (BertForPretraining, BertForSequenceClassification,  # noqa: F401
                   BertLMPredictionHead, BertModel, BertPretrainingCriterion,
                   ErnieForSequenceClassification, ErnieModel)
from .convert import (export_paddle_tpu_state_dict,  # noqa: F401
                      export_paddle_tpu_tensors, load_paddle_tpu_state_dict)
from .gpt import (GPTDecoderLayer, GPTForCausalLM,  # noqa: F401
                  GPTForCausalLMPipe, GPTModel, block_fn_for,
                  pipeline_forward, stack_block_params)
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
