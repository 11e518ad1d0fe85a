"""BERT / ERNIE sequence-classification fine-tune through ``hapi.Model``
(counterpart of ``examples/finetune_bert.py``): a toy sentiment corpus,
a ``BertTokenizer`` built from it, AdamW and cross entropy with accuracy,
``Model.fit`` then ``Model.evaluate``.  Runs on the card by default:

    python -m paddle_tpu_torch.examples.finetune_bert [--model ernie|bert]
        [--epochs 3] [--batch-size 16] [--max-len 32] [--lr 5e-4]
        [--device cpu]

:func:`build_data`, :func:`build_model` and :func:`finetune` are the
recipe's steps, so a caller can run it with its own dropout or device;
:func:`main` parses the reference's flags (and ``--device``).
"""

from __future__ import annotations

import argparse

import numpy as np

from paddle_tpu_torch import Model, nn, seed
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.text import (BertForSequenceClassification,
                                   BertTokenizer,
                                   ErnieForSequenceClassification)

TOY_SST = [
    ("a triumph of wit and craft", 1),
    ("gorgeous, moving, expertly acted", 1),
    ("one of the year's best films", 1),
    ("sharp writing and a brilliant cast", 1),
    ("dull, lifeless, and painfully long", 0),
    ("a waste of everyone's talent and time", 0),
    ("the plot collapses into nonsense", 0),
    ("clumsy pacing and wooden dialogue", 0),
] * 8


def build_data(max_len=32):
    """``(ids [64, max_len] int64, labels [64] int64, vocab size rounded
    up to a multiple of 8)`` of the toy corpus."""
    texts = [t for t, _ in TOY_SST]
    labels = np.array([label for _, label in TOY_SST], dtype="int64")
    tok = BertTokenizer.from_corpus(texts, min_freq=1)
    vocab = ((tok.vocab_size + 7) // 8) * 8
    ids = np.array([tok(t, max_length=max_len)["input_ids"] for t in texts],
                   dtype="int64")
    return ids, labels, vocab


def build_model(kind="ernie", vocab=None, max_len=32, dropout=0.1,
                device=None):
    """The example's classifier (hidden 128, 4 layers of 4 heads, FFN
    256), seeded with 0.  ``dropout`` sets the hidden and attention
    dropouts (the reference's 0.1); the classifier's dropout is 0.1 unless
    ``dropout`` is 0."""
    seed(0)
    cls = ErnieForSequenceClassification if kind == "ernie" else \
        BertForSequenceClassification
    return cls(num_classes=2, vocab_size=vocab, hidden_size=128,
               num_hidden_layers=4, num_attention_heads=4,
               intermediate_size=256, max_position_embeddings=max_len,
               hidden_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout,
               dropout=None if dropout else 0.0, device=device)


def finetune(net, ids, labels, epochs=3, batch_size=16, lr=5e-4, verbose=1,
             callbacks=None, shuffle=True, device=None):
    """``Model.fit`` on ``device`` (the card unless ``"cpu"`` is asked for)
    with AdamW(lr) and cross entropy + accuracy, then ``evaluate`` on the
    same data; returns ``(model, eval logs)``."""
    model = Model(net, device=device)
    model.prepare(opt.AdamW(learning_rate=lr, parameters=net.parameters()),
                  nn.CrossEntropyLoss(), Accuracy())
    data = TensorDataset([ids, labels])
    model.fit(data, epochs=epochs, batch_size=batch_size, verbose=verbose,
              callbacks=callbacks, shuffle=shuffle)
    return model, model.evaluate(data, batch_size=batch_size, verbose=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ernie", choices=["ernie", "bert"])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)

    ids, labels, vocab = build_data(args.max_len)
    net = build_model(args.model, vocab, args.max_len, device=args.device)
    _, logs = finetune(net, ids, labels, epochs=args.epochs,
                       batch_size=args.batch_size, lr=args.lr,
                       device=args.device)
    print("final:", logs)
    return logs


if __name__ == "__main__":
    main()
