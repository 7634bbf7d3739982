"""Text classification (counterpart of ``bigdl_tpu/cli/textclassification.py``;
reference example/textclassification/TextClassifier.scala:40-220: GloVe
embeddings and a text CNN over 20 Newsgroups)::

    python -m bigdl_tpu_torch.cli.textclassification -f BASE \\
        [--embeddingDim 100] [--sequenceLength 500] [--maxWordsNum 5000] \\
        [--trainingSplit 0.8] [-b 128] [--maxEpoch 5] [--platform cpu]

BASE is laid out as the reference's baseDir::

    BASE/
      20news-18828/<group-name>/<doc files>     (a class a folder)
      glove.6B/glove.6B.<dim>d.txt              (optional vectors)

Each document's first ``--sequenceLength`` words become ids of a
dictionary of the ``--maxWordsNum`` most frequent words, padded to that
length; a ``RandomState(--seed)`` permutation splits them into training
and validation at ``--trainingSplit``. Without GloVe vectors the
embedding trains from its own init; without a corpus a synthetic
two-class one is made. The model is the text CNN: embeddings (B, T, dim)
-> TemporalConvolution/ReLU/TemporalMaxPooling twice -> Linear -> ReLU ->
Linear -> LogSoftMax, trained with SGD at the common flags' defaults and
validated (Top-1) every epoch.
"""

from __future__ import annotations

import argparse
import logging
import os

from bigdl_tpu_torch.cli import common

__all__ = ["load_glove", "read_corpus", "synthetic_corpus", "split_corpus",
           "build_model", "main"]

logger = logging.getLogger("bigdl_tpu_torch")


def load_glove(path: str, dictionary, dim: int):
    """A (len(dictionary), dim) f32 table: the GloVe row of each dictionary
    word in the file, ``RandomState(0).normal(0, 0.05)`` draws for the
    rest."""
    import numpy as np

    table = np.random.RandomState(0).normal(
        0, 0.05, (len(dictionary), dim)).astype(np.float32)
    hits = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            idx = dictionary.word2id.get(parts[0])  # OOV skipped (UNK is 1)
            if idx is not None and len(parts) == dim + 1:
                table[idx] = np.asarray(parts[1:], np.float32)
                hits += 1
    logger.info("GloVe: %d/%d dictionary words covered", hits,
                len(dictionary))
    return table


def read_corpus(base: str):
    """(texts, labels, class_names) from a 20news-style folder tree, or
    None when ``base`` holds none."""
    root = None
    for cand in ("20news-18828", "20_newsgroup", "corpus"):
        p = os.path.join(base, cand)
        if os.path.isdir(p):
            root = p
            break
    if root is None:
        return None
    texts, labels, names = [], [], []
    for cls in sorted(os.listdir(root)):
        cdir = os.path.join(root, cls)
        if not os.path.isdir(cdir):  # stray files must not shift label ids
            continue
        ci = len(names)
        names.append(cls)
        for fn in sorted(os.listdir(cdir)):
            try:
                with open(os.path.join(cdir, fn), errors="ignore") as f:
                    texts.append(f.read())
                labels.append(ci)
            except OSError:
                continue
    return texts, labels, names


def synthetic_corpus(n_per_class: int = 200, seed: int = 0):
    """Two topics of nearly disjoint words, learnable by any text model;
    used when there is no corpus."""
    import numpy as np

    rs = np.random.RandomState(seed)
    topics = [
        ["game", "team", "score", "play", "season", "win", "coach",
         "league", "player", "ball"],
        ["code", "kernel", "memory", "compile", "driver", "linux",
         "system", "program", "software", "bug"],
    ]
    filler = ["the", "a", "of", "and", "to", "in", "is", "it", "for", "on"]
    texts, labels = [], []
    for ci, vocab in enumerate(topics):
        for _ in range(n_per_class):
            words = [
                (vocab if rs.rand() < 0.4 else filler)[
                    rs.randint(0, 10)] for _ in range(60)
            ]
            texts.append(" ".join(words))
            labels.append(ci)
    return texts, labels, ["sports", "computing"]


def split_corpus(folder: str, seq_len: int, max_words: int, seed: int,
                 split: float):
    """The corpus under ``folder`` (the synthetic one where there is none)
    as padded ids: ``(x, y, n_train, dictionary, class_names)`` with x and
    y in the ``RandomState(seed)`` order whose first ``n_train`` rows
    train."""
    import numpy as np

    from bigdl_tpu_torch.dataset.text import (Dictionary, pad_sequences,
                                              tokenize)

    corpus = read_corpus(folder)
    if corpus is None:
        logger.warning("no corpus under %s — using the synthetic two-class "
                       "corpus", folder)
        corpus = synthetic_corpus()
    texts, labels, names = corpus
    toks = [tokenize(t)[:seq_len] for t in texts]
    d = Dictionary(toks, vocab_size=max_words)
    x = np.asarray(pad_sequences([d.ids(t) for t in toks], seq_len),
                   np.int32)
    y = np.asarray(labels, np.int32)
    order = np.random.RandomState(seed).permutation(len(x))
    return x[order], y[order], int(len(x) * split), d, names


def build_model(vocab: int, emb_dim: int, seq_len: int, n_class: int,
                emb_table=None, generator=None):
    """The text CNN (128 filters of width 5 and pooling by 5, twice, then
    the dense head), its embedding set to ``emb_table`` when given."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential

    lut = nn.LookupTable(vocab, emb_dim, generator=generator)
    if emb_table is not None:
        with torch.no_grad():
            lut.weight.copy_(torch.from_numpy(emb_table))
    return Sequential(
        lut,
        nn.TemporalConvolution(emb_dim, 128, 5, generator=generator),
        nn.ReLU(),
        nn.TemporalMaxPooling(5, 5),
        nn.TemporalConvolution(128, 128, 5, generator=generator),
        nn.ReLU(),
        nn.TemporalMaxPooling(5, 5),
        nn.Lambda(lambda x: x.reshape(x.shape[0], -1), name="Flatten"),
        nn.Linear(128 * (((seq_len - 4) // 5 - 4) // 5), 128,
                  generator=generator),
        nn.ReLU(),
        nn.Linear(128, n_class, generator=generator), nn.LogSoftMax(),
        name="TextCNN",
    )


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser(
        "python -m bigdl_tpu_torch.cli.textclassification")
    common.add_train_args(p)
    p.add_argument("--embeddingDim", type=int, default=100)
    p.add_argument("--sequenceLength", type=int, default=500)
    p.add_argument("--maxWordsNum", type=int, default=5000)
    p.add_argument("--trainingSplit", type=float, default=0.8)
    args = p.parse_args(argv)

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.optim import Top1Accuracy, Trigger

    common.apply_platform(args)  # refuse before reading the data
    x, y, n_train, d, names = split_corpus(
        args.folder, args.sequenceLength, args.maxWordsNum, args.seed,
        args.trainingSplit)
    emb = None
    glove = os.path.join(args.folder, "glove.6B",
                         f"glove.6B.{args.embeddingDim}d.txt")
    if os.path.isfile(glove):
        emb = load_glove(glove, d, args.embeddingDim)
    val = BatchDataSet(x[n_train:], y[n_train:], args.batchSize)

    def _make():  # each attempt from the seed: a failed one moved on
        model = build_model(len(d), args.embeddingDim, args.sequenceLength,
                            len(names), emb, generator=torch.Generator(
                                ).manual_seed(args.seed))
        train = BatchDataSet(x[:n_train], y[:n_train], args.batchSize,
                             shuffle=True)
        opt = common.build_optimizer(model, train, nn.ClassNLLCriterion(),
                                     args)
        opt.set_validation(Trigger.every_epoch(), val, [Top1Accuracy()])
        return opt

    return common.run_optimize(_make, args)


if __name__ == "__main__":
    main()
