"""paddle_tpu_torch.text (counterpart of ``paddle_tpu/text``): the model
zoo (GPT, Llama, BERT / ERNIE) and the tokenizers."""

from . import models  # noqa: F401
from .models import (BertForPretraining, BertForSequenceClassification,  # noqa: F401
                     BertModel, ErnieForSequenceClassification, ErnieModel,
                     GPTForCausalLM, GPTModel)
from .tokenizer import BertTokenizer, SimpleTokenizer  # noqa: F401
