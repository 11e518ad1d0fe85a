"""Tokenizers (counterpart of ``paddle_tpu/text/tokenizer.py``, copied:
it is pure Python).  ``SimpleTokenizer`` is word-level over a built
vocabulary; ``BertTokenizer`` adds greedy longest-match WordPiece.
Vocabularies are built from corpora (``BertTokenizer.from_corpus``) or
read from a local vocab file, never downloaded.
"""

from __future__ import annotations

import collections
import re
import unicodedata


class SimpleTokenizer:
    """Whitespace/punctuation word-level tokenizer with a built vocab."""

    PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"

    def __init__(self, vocab=None, lower=True):
        self.lower = lower
        specials = [self.PAD, self.UNK, self.CLS, self.SEP, self.MASK]
        if vocab is None:
            vocab = []
        ordered = specials + [w for w in vocab if w not in specials]
        self.vocab = {w: i for i, w in enumerate(ordered)}
        self.inv_vocab = {i: w for w, i in self.vocab.items()}

    @classmethod
    def from_corpus(cls, texts, max_vocab=30000, lower=True):
        counter = collections.Counter()
        for t in texts:
            counter.update(cls._basic_tokens(t, lower))
        words = [w for w, _ in counter.most_common(max_vocab)]
        return cls(words, lower)

    @staticmethod
    def _basic_tokens(text, lower=True):
        if lower:
            text = text.lower()
        text = unicodedata.normalize("NFKC", text)
        return re.findall(r"\w+|[^\w\s]", text)

    @property
    def vocab_size(self):
        return len(self.vocab)

    @property
    def pad_token_id(self):
        return self.vocab[self.PAD]

    @property
    def unk_token_id(self):
        return self.vocab[self.UNK]

    @property
    def cls_token_id(self):
        return self.vocab[self.CLS]

    @property
    def sep_token_id(self):
        return self.vocab[self.SEP]

    @property
    def mask_token_id(self):
        return self.vocab[self.MASK]

    def tokenize(self, text):
        return [t if t in self.vocab else self.UNK
                for t in self._basic_tokens(text, self.lower)]

    def convert_tokens_to_ids(self, tokens):
        unk = self.unk_token_id
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        return [self.inv_vocab.get(int(i), self.UNK) for i in ids]

    def __call__(self, text, text_pair=None, max_length=128, padding="max_length",
                 truncation=True, return_token_type_ids=True):
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        pair = self.convert_tokens_to_ids(self.tokenize(text_pair)) if text_pair else []
        cls_, sep = self.cls_token_id, self.sep_token_id
        input_ids = [cls_] + ids + [sep] + (pair + [sep] if pair else [])
        token_type = [0] * (len(ids) + 2) + [1] * (len(pair) + 1 if pair else 0)
        if truncation:
            input_ids = input_ids[:max_length]
            token_type = token_type[:max_length]
        attn = [1] * len(input_ids)
        if padding == "max_length":
            pad = max_length - len(input_ids)
            input_ids += [self.pad_token_id] * pad
            token_type += [0] * pad
            attn += [0] * pad
        return {"input_ids": input_ids, "token_type_ids": token_type,
                "attention_mask": attn}


class BertTokenizer(SimpleTokenizer):
    """WordPiece on top of the basic tokenizer (reference BertTokenizer).

    Build with ``from_corpus`` (learns greedy-longest-match wordpieces from
    word frequency) or with an explicit vocab list/file.
    """

    def __init__(self, vocab=None, lower=True, wordpiece=True,
                 max_input_chars_per_word=100):
        super().__init__(vocab, lower)
        self.wordpiece = wordpiece
        self.max_chars = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path, lower=True):
        with open(path) as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab, lower)

    @classmethod
    def from_corpus(cls, texts, max_vocab=30000, lower=True, min_freq=2):
        counter = collections.Counter()
        for t in texts:
            counter.update(cls._basic_tokens(t, lower))
        # whole words + suffix pieces (##x) by frequency
        pieces = collections.Counter()
        for w, c in counter.items():
            pieces[w] += c
            for i in range(1, len(w)):
                pieces[w[:i]] += c
                pieces["##" + w[i:]] += c
        words = [w for w, c in pieces.most_common(max_vocab) if c >= min_freq]
        return cls(words, lower)

    def _wordpiece(self, word):
        if len(word) > self.max_chars:
            return [self.UNK]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.UNK]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text):
        out = []
        for w in self._basic_tokens(text, self.lower):
            if not self.wordpiece or w in self.vocab:
                out.append(w if w in self.vocab else self.UNK)
            else:
                out.extend(self._wordpiece(w))
        return out
