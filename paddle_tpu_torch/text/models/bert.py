"""BERT / ERNIE encoders (counterpart of ``paddle_tpu/text/models/bert.py``).

A post-LN ``TransformerEncoder`` under word + position + token-type
embeddings, a tanh pooler over the first token, the classification head,
and the pretraining heads (MLM tied to the word table, NSP).  ERNIE-3.0
base is the same encoder with its own defaults (vocab 40000, 2048
positions, 4 token types).

``BertModel`` always builds the additive pad mask ``[B, 1, 1, S]``
(-1e4 where ``input_ids == pad_token_id``, or where ``attention_mask`` is
0), as the reference does, so its attention is the plain masked one on
every device: no flash kernel runs, in the reference or here.  Its GEMMs
are cuBLAS's on the card, as the reference's are XLA dots.

Each model takes ``device=`` (None: the card, an error without one;
``"cpu"``) and ``dtype=``, as the GPT port does: its weights are drawn on
the CPU from torch's default generator and then moved.
"""

from __future__ import annotations

import types

import torch

from ... import amp
from ...device import resolve_device
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layers.common import Dropout, Embedding, Linear, promote
from ...nn.layers.norm import LayerNorm
from ...nn.layers.transformer import (TransformerEncoder,
                                      TransformerEncoderLayer)


class BertEmbeddings(torch.nn.Module):
    def __init__(self, vocab_size, hidden_size, hidden_dropout_prob,
                 max_position_embeddings, type_vocab_size, pad_token_id=0):
        super().__init__()
        self.word_embeddings = Embedding(vocab_size, hidden_size,
                                         padding_idx=pad_token_id)
        self.position_embeddings = Embedding(max_position_embeddings,
                                             hidden_size)
        self.token_type_embeddings = Embedding(type_vocab_size, hidden_size)
        self.layer_norm = LayerNorm(hidden_size, 1e-12)
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(torch.nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


def _place(module, device, dtype):
    module.to(device=resolve_device(device), dtype=dtype)


class BertModel(torch.nn.Module):
    """``(sequence_output, pooled_output)`` of ``input_ids`` ``[B, S]``."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, max_position_embeddings=512,
                 type_vocab_size=2, initializer_range=0.02, pad_token_id=0,
                 pool_act="tanh", device=None, dtype=None):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.embeddings = BertEmbeddings(vocab_size, hidden_size,
                                         hidden_dropout_prob,
                                         max_position_embeddings,
                                         type_vocab_size, pad_token_id)
        enc_layer = TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size,
            dropout=hidden_dropout_prob, activation=hidden_act,
            attn_dropout=attention_probs_dropout_prob, act_dropout=0.0,
            normalize_before=False, layer_norm_eps=1e-12)
        self.encoder = TransformerEncoder(enc_layer, num_hidden_layers)
        self.pooler = BertPooler(hidden_size)
        _place(self, device, dtype)

    def _attn_mask(self, input_ids, attention_mask):
        if attention_mask is None:
            attention_mask = (input_ids != self.pad_token_id).float()
        # [B, S] -> additive [B, 1, 1, S], float32
        return ((1.0 - attention_mask.float()) * -1e4)[:, None, None, :]

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        mask = self._attn_mask(input_ids, attention_mask)
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(emb, mask)
        return seq_out, self.pooler(seq_out)


class ErnieModel(BertModel):
    """ERNIE-3.0-base shape defaults (a BERT-base-compatible encoder)."""

    def __init__(self, vocab_size=40000, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=2048, type_vocab_size=4,
                 initializer_range=0.02, pad_token_id=0, device=None,
                 dtype=None, **kw):
        super().__init__(vocab_size, hidden_size, num_hidden_layers,
                         num_attention_heads, intermediate_size, hidden_act,
                         hidden_dropout_prob, attention_probs_dropout_prob,
                         max_position_embeddings, type_vocab_size,
                         initializer_range, pad_token_id, device=device,
                         dtype=dtype)


class BertForSequenceClassification(torch.nn.Module):
    def __init__(self, bert=None, num_classes=2, dropout=None, device=None,
                 dtype=None, **bert_kwargs):
        super().__init__()
        self.bert = bert if bert is not None else \
            BertModel(device="cpu", **bert_kwargs)
        hidden = self.bert.pooler.dense.weight.shape[0]
        self.dropout = Dropout(dropout if dropout is not None else 0.1)
        self.classifier = Linear(hidden, num_classes)
        _place(self, device, dtype)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForSequenceClassification(BertForSequenceClassification):
    def __init__(self, ernie=None, num_classes=2, dropout=None, device=None,
                 dtype=None, **kw):
        super().__init__(bert=ernie if ernie is not None
                         else ErnieModel(device="cpu", **kw),
                         num_classes=num_classes, dropout=dropout,
                         device=device, dtype=dtype)


class BertLMPredictionHead(torch.nn.Module):
    """MLM head: transform, activation, layer norm, then the vocabulary
    projection.  Tied (``embedding_weights``: the word table, or the
    ``Embedding`` that owns it), it reads the table at each call and does
    not register it as a parameter of its own, so the optimizer updates it
    once and the state dict holds it once (under the embedding's name).
    Given the module, it reads ``module.weight``, which
    ``torch.func.functional_call`` rebinds (``jit.TrainStep`` at O2)."""

    def __init__(self, hidden_size, vocab_size, activation="gelu",
                 embedding_weights=None):
        super().__init__()
        self.transform = Linear(hidden_size, hidden_size)
        self.activation = getattr(F, activation)
        self.layer_norm = LayerNorm(hidden_size, 1e-12)
        if embedding_weights is None:
            self.decoder_weight = torch.nn.Parameter(
                I.XavierNormal()((vocab_size, hidden_size)))
        else:
            owner = embedding_weights \
                if isinstance(embedding_weights, torch.nn.Module) \
                else types.SimpleNamespace(weight=embedding_weights)
            # outside _modules / _parameters: no second registration
            self.__dict__["_tied_owner"] = owner
        self.decoder_bias = torch.nn.Parameter(torch.zeros(vocab_size))

    @property
    def _weight(self):
        owner = self.__dict__.get("_tied_owner")
        return owner.weight if owner is not None else self.decoder_weight

    def forward(self, hidden_states):
        h = self.layer_norm(self.activation(self.transform(hidden_states)))
        h, w, b = promote(*amp.cast("matmul", h, self._weight,
                                    self.decoder_bias))
        return h @ w.T + b


class BertForPretraining(torch.nn.Module):
    """MLM + NSP heads; ``(prediction_scores, seq_relationship_score)``."""

    def __init__(self, bert=None, device=None, dtype=None, **bert_kwargs):
        super().__init__()
        self.bert = bert if bert is not None else \
            BertModel(device="cpu", **bert_kwargs)
        hidden = self.bert.pooler.dense.weight.shape[0]
        word = self.bert.embeddings.word_embeddings
        self.cls = BertLMPredictionHead(hidden, word.weight.shape[0],
                                        embedding_weights=word)
        self.nsp = Linear(hidden, 2)
        _place(self, device, dtype)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        return self.cls(seq), self.nsp(pooled)


class BertPretrainingCriterion(torch.nn.Module):
    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels, masked_lm_scale=1.0):
        mlm = F.cross_entropy(prediction_scores.reshape(-1, self.vocab_size),
                              masked_lm_labels.reshape(-1), ignore_index=-100,
                              reduction="mean")
        nsp = F.cross_entropy(seq_relationship_score,
                              next_sentence_labels.reshape(-1),
                              reduction="mean")
        return mlm + nsp
