"""BASELINE config 5 in the port against the JAX package, on the CPU: the
text pipeline (``dataset.text``), the four builders of ``models/rnn.py``
from one JAX init tree (``load_jax``), ``cli.textclassification`` (its
corpus, dictionary ids, split and GloVe table against the JAX CLI's, and
a short run) and ``cli.rnn``.

Tolerances: the builders' log-probs atol 1e-5 in f32 (``text_cnn``'s
1e-4: three convolutions of 40 to 80 terms a sum, and two dense layers);
ids, splits and tables are compared exactly."""

import logging
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import common as jax_common
from bigdl_tpu.cli import textclassification as jax_tc
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.cli import rnn as rnn_cli
from bigdl_tpu_torch.cli import textclassification as tc
from bigdl_tpu_torch.dataset import text
from bigdl_tpu_torch.interop import load_jax

ATOL = 1e-5
CNN_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ dataset.text
def test_text_pipeline_matches_jax():
    rs = np.random.RandomState(0)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta"]
    sents = [[words[i] for i in rs.randint(0, 7, rs.randint(1, 12))]
             for _ in range(9)]
    labels = rs.randint(0, 3, 9)
    jd = jtext.Dictionary(sents, vocab_size=5)
    td = text.Dictionary(sents, vocab_size=5)
    assert td.word2id == jd.word2id
    seqs = [jd.ids(s) for s in sents]
    for trunc in (True, False):
        np.testing.assert_array_equal(
            text.pad_sequences(seqs, 6, pad_id=0, truncate_from_end=trunc),
            jtext.pad_sequences(seqs, 6, pad_id=0, truncate_from_end=trunc))
    jl = [jtext.LabeledSentence(s, int(y)) for s, y in zip(sents, labels)]
    tl = [text.LabeledSentence(s, int(y)) for s, y in zip(sents, labels)]
    for a, b in zip(text.sentences_to_ids(tl, td, 8),
                    jtext.sentences_to_ids(jl, jd, 8)):
        np.testing.assert_array_equal(a, b)
    got = list(text.LabeledSentenceToSample(td, 8).apply(tl))
    ref = list(jtext.LabeledSentenceToSample(jd, 8).apply(jl))
    assert len(got) == len(ref) == 9
    for (gi, gy), (ri, ry) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        assert gi.dtype == np.int32 and gy == ry and gy.dtype == np.int32


# ------------------------------------------------------------- the models
def _builders():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 20, (4, 9)).astype(np.int32)
    return {
        "simple_rnn": (jax_models.simple_rnn(7, 5, 6),
                       models.simple_rnn(7, 5, 6),
                       rs.randn(4, 9, 7).astype(np.float32), ATOL),
        "lstm_classifier": (jax_models.lstm_classifier(20, 6, 5, 3),
                            models.lstm_classifier(20, 6, 5, 3), ids, ATOL),
        "birnn_classifier": (jax_models.birnn_classifier(20, 6, 5, 3),
                             models.birnn_classifier(20, 6, 5, 3), ids,
                             ATOL),
        "text_cnn": (jax_models.text_cnn(150, 8, 3, filters=16),
                     models.text_cnn(150, 8, 3, filters=16),
                     rs.randn(4, 150, 8).astype(np.float32), CNN_ATOL),
    }


@pytest.mark.parametrize("name", ["simple_rnn", "lstm_classifier",
                                  "birnn_classifier", "text_cnn"])
def test_builder_matches_jax(name):
    jm, tm, x, atol = _builders()[name]
    params = _np_tree(jm.init(jax.random.PRNGKey(5)))
    load_jax(tm, params)
    assert tm.name == jm.name
    tm.eval()
    ref = jm.forward(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == ref.shape
    _close(got, ref, atol)


def test_simple_rnn_truncates_every_two_steps():
    m = models.simple_rnn(7, 5, 6)
    assert m[0].bptt_truncate == 2 and not m[0].return_sequences
    assert models.simple_rnn(7, 5, 6, bptt_truncate=0)[0].bptt_truncate == 0


def test_text_cnn_refuses_short_sequences():
    models.text_cnn(149, 8, 3, filters=4)
    for build in (models.text_cnn, jax_models.text_cnn):
        with pytest.raises(ValueError, match="needs >= 149"):
            build(148, 8, 3)


# ------------------------------------------------- cli.textclassification
def _write_news(base, classes=3, docs=6, seed=0):
    """A 20news-style tree: ``classes`` folders of ``docs`` documents, each
    class with its own topic words among shared ones, and a stray file
    that must not shift the label ids."""
    rs = np.random.RandomState(seed)
    shared = [f"common{chr(97 + i)}" for i in range(12)]
    root = os.path.join(base, "20news-18828")
    os.makedirs(root)
    open(os.path.join(root, "README"), "w").write("not a class")
    for c in range(classes):
        topic = [f"topic{chr(97 + c)}{chr(97 + i)}" for i in range(6)]
        cdir = os.path.join(root, f"group{c}")
        os.makedirs(cdir)
        for d in range(docs):
            n = rs.randint(40, 90)
            words = [(topic if rs.rand() < 0.4 else shared)[rs.randint(0, 6)]
                     for _ in range(n)]
            with open(os.path.join(cdir, f"{d:03d}"), "w") as f:
                f.write(" ".join(words) + ".")


def _write_glove(base, dim, words):
    rs = np.random.RandomState(1)
    gdir = os.path.join(base, "glove.6B")
    os.makedirs(gdir)
    with open(os.path.join(gdir, f"glove.6B.{dim}d.txt"), "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rs.randn(dim))
                    + "\n")
        f.write("shortrow 0.5\n")  # a row of the wrong width is skipped


def _jax_split(monkeypatch, argv):
    """The JAX CLI's training and validation arrays and GloVe table, taken
    where it builds them (its optimisation is not run)."""
    seen = {}

    class Capture:
        def __init__(self, x, y, batch, shuffle=False, **kw):
            seen.setdefault("sets", []).append((x, y))

    def build_model(vocab, emb_dim, seq_len, n_class, emb_table=None):
        seen["model"] = (vocab, emb_dim, seq_len, n_class)
        seen["emb"] = emb_table

    import bigdl_tpu.dataset as jds
    monkeypatch.setattr(jds, "BatchDataSet", Capture)
    monkeypatch.setattr(jax_tc, "build_model", build_model)
    monkeypatch.setattr(jax_common, "run_optimize", lambda make, args: None)
    jax_tc.main(argv)
    return seen


def test_textclassification_split_and_glove_equal_the_jax_cli(
        tmp_path, monkeypatch):
    _write_news(str(tmp_path))
    words = ["topicaa", "topicbc", "commonb", "unseenword"]
    _write_glove(str(tmp_path), 16, words)
    argv = ["-f", str(tmp_path), "--sequenceLength", "60", "--embeddingDim",
            "16", "--seed", "7", "--platform", "cpu"]
    ref = _jax_split(monkeypatch, argv)
    x, y, n_train, d, names = tc.split_corpus(str(tmp_path), 60, 5000, 7,
                                              0.8)
    assert names == ["group0", "group1", "group2"]
    (jxt, jyt), (jxv, jyv) = ref["sets"]
    for got, want in ((x[:n_train], jxt), (y[:n_train], jyt),
                      (x[n_train:], jxv), (y[n_train:], jyv)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert ref["model"] == (len(d), 16, 60, 3)
    glove = os.path.join(str(tmp_path), "glove.6B", "glove.6B.16d.txt")
    table = tc.load_glove(glove, d, 16)
    assert table.dtype == ref["emb"].dtype and table.shape == (len(d), 16)
    assert table.tobytes() == ref["emb"].tobytes()
    assert table.tobytes() == jax_tc.load_glove(glove, d, 16).tobytes()
    # the table is the embedding's weight, bit for bit
    model = tc.build_model(len(d), 16, 60, 3, table)
    assert model[0].weight.detach().numpy().tobytes() == table.tobytes()


def test_synthetic_corpus_equals_the_jax_one():
    for seed in (0, 3):
        assert tc.synthetic_corpus(20, seed) == jax_tc.synthetic_corpus(
            20, seed)
    assert tc.read_corpus("/nonexistent-dir") is None


def _lines(caplog):
    return [r.getMessage() for r in caplog.records]


def test_textclassification_cli_trains_two_epochs(tmp_path, caplog):
    _write_news(str(tmp_path), docs=8, seed=2)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    trained = tc.main(["-f", str(tmp_path), "--sequenceLength", "60",
                       "--embeddingDim", "16", "-b", "4", "--maxEpoch",
                       "2", "--logEvery", "1", "--platform", "cpu"])
    msgs = _lines(caplog)
    losses = [float(m.rsplit(" ", 1)[1]) for m in msgs if "Loss is" in m]
    assert len(losses) == 2 * (int(24 * 0.8) // 4)
    assert all(math.isfinite(v) for v in losses)
    top1 = [m for m in msgs if m.startswith("top1 accuracy is ")]
    assert len(top1) == 2 and trained.module.name == "TextCNN"


# ----------------------------------------------------------------- cli.rnn
def test_rnn_cli_trains_and_prints_perplexity(tmp_path, capsys, caplog,
                                              monkeypatch):
    rs = np.random.RandomState(4)
    vocab = [f"w{chr(97 + i)}{chr(97 + j)}" for i in range(5)
             for j in range(6)]
    words = [vocab[min(int(rs.zipf(1.5)) - 1, 29)] for _ in range(500)]
    (tmp_path / "input.txt").write_text(" ".join(words))
    built = {}
    real = common.build_optimizer

    def build(model, *a, **kw):
        built["model"] = model
        return real(model, *a, **kw)

    monkeypatch.setattr(common, "build_optimizer", build)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    rnn_cli.main(["train", "-f", str(tmp_path), "--vocabSize", "20",
                  "--seqLength", "5", "--hiddenSize", "8", "-b", "16",
                  "--maxEpoch", "1", "--logEvery", "1", "--platform",
                  "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"^perplexity is (\S+)$", out, re.M)
    assert m and math.isfinite(float(m.group(1)))
    losses = [float(s.rsplit(" ", 1)[1]) for s in _lines(caplog)
              if "Loss is" in s]
    n_held = min(512, max(1, 495 // 10))
    assert len(losses) == (495 - n_held) // 16
    assert all(math.isfinite(v) for v in losses)
    # the LM is the JAX CLI's: its tree loads strictly by name
    model = built["model"]
    v = model[0].n_index
    assert v == 22 and model.name == "SimpleRNN-LM"
    jm = JSequential(jnn.LookupTable(v, v),
                     *jax_models.simple_rnn(v, 8, v).children())
    load_jax(model, _np_tree(jm.init(jax.random.PRNGKey(0))))
    assert model[1].bptt_truncate == 2
