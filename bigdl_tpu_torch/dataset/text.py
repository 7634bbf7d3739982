"""The text pipeline (the port's own copy of ``bigdl_tpu/dataset/text.py``;
reference dataset/text/: LabeledSentence, LabeledSentenceToSample;
models/rnn/Utils.scala WordTokenizer and dictionary): tokenization, a
dictionary capped by frequency, fixed-length padding and packing, and the
sentence-to-sample stage."""

from __future__ import annotations

import re
from collections import Counter
from typing import Iterable, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["tokenize", "Dictionary", "pad_sequences", "pack_sequences",
           "LabeledSentence", "sentences_to_ids", "LabeledSentenceToSample",
           "PAD", "UNK"]

PAD, UNK = "<pad>", "<unk>"
_WORD_RE = re.compile(r"[A-Za-z']+|[.,!?;]")


def tokenize(text: str) -> list:
    """Lower-cased words and the punctuation marks . , ! ? ;"""
    return _WORD_RE.findall(text.lower())


class LabeledSentence:
    """A (tokens, label) pair (reference dataset/text/LabeledSentence)."""

    __slots__ = ("data", "label")

    def __init__(self, data: Sequence, label: int):
        self.data = list(data)
        self.label = label


class Dictionary:
    """Word -> id, capped at the ``vocab_size`` most frequent words (ties
    in first-seen order); id 0 = PAD, id 1 = UNK, rarer words map to UNK."""

    def __init__(self, corpus_tokens: Iterable[Sequence[str]],
                 vocab_size: Optional[int] = None):
        counts = Counter()
        for toks in corpus_tokens:
            counts.update(toks)
        self.word2id = {PAD: 0, UNK: 1}
        for w, _ in counts.most_common(vocab_size):
            self.word2id[w] = len(self.word2id)
        self.id2word = {i: w for w, i in self.word2id.items()}

    def __len__(self):
        return len(self.word2id)

    def lookup(self, word: str) -> int:
        return self.word2id.get(word, 1)

    def ids(self, tokens: Sequence[str]) -> list:
        return [self.lookup(t) for t in tokens]


def pad_sequences(seqs: Sequence[Sequence[int]], max_len: int,
                  pad_id: int = 0, truncate_from_end: bool = True):
    """Fixed-length (N, max_len) int32 rows, ``pad_id`` after each
    sequence; a longer one keeps its first ``max_len`` ids (its last with
    ``truncate_from_end=False``)."""
    out = np.full((len(seqs), max_len), pad_id, np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:max_len] if truncate_from_end else list(s)[-max_len:]
        out[i, :len(s)] = s
    return out


def pack_sequences(seqs: Sequence[Sequence[int]], max_len: int,
                   pad_id: int = 0):
    """Greedy first-fit packing of token sequences into (N, max_len) rows
    plus segment ids (1, 2, ... per row; 0 = padding). Longer sequences
    are truncated. Returns (tokens, segments), both int32."""
    rows, segs, free = [], [], []
    for s in seqs:
        s = list(s)[:max_len]
        if not s:
            continue
        for i, cap in enumerate(free):
            if len(s) <= cap:
                seg_id = segs[i][-1] + 1
                rows[i].extend(s)
                segs[i].extend([seg_id] * len(s))
                free[i] = cap - len(s)
                break
        else:
            rows.append(list(s))
            segs.append([1] * len(s))
            free.append(max_len - len(s))
    tokens = np.full((len(rows), max_len), pad_id, np.int32)
    segments = np.zeros((len(rows), max_len), np.int32)
    for i, (r, g) in enumerate(zip(rows, segs)):
        tokens[i, :len(r)] = r
        segments[i, :len(g)] = g
    return tokens, segments


def sentences_to_ids(sentences: Sequence[LabeledSentence],
                     dictionary: Dictionary, max_len: int):
    """-> (ids (N, max_len) int32, labels (N,) int32)"""
    ids = pad_sequences([dictionary.ids(s.data) for s in sentences], max_len)
    labels = np.asarray([s.label for s in sentences], np.int32)
    return ids, labels


class LabeledSentenceToSample(Transformer):
    """Transformer stage: LabeledSentence -> (ids[max_len] int32, label)
    sample pairs, padded to a fixed length (reference
    dataset/text/LabeledSentenceToSample.scala pads to the batch's
    longest). Composes with ``>>`` like any Transformer."""

    def __init__(self, dictionary: Dictionary, max_len: int):
        self.dictionary = dictionary
        self.max_len = max_len

    def __call__(self, it):
        for s in it:
            ids = pad_sequences([self.dictionary.ids(s.data)],
                                self.max_len)[0]
            yield ids, np.int32(s.label)
