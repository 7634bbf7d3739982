"""Recurrent text models (counterpart of ``bigdl_tpu/models/rnn.py``).

* ``simple_rnn``: the reference's SimpleRNN (models/rnn/Model.scala:23-37:
  Recurrent(RnnCell + Tanh), the last step, Linear, LogSoftMax) for
  next-word prediction.
* ``lstm_classifier`` / ``birnn_classifier``: BASELINE config 5, "LSTM /
  BiRNN text classification": embedding -> (Bi)LSTM -> last state ->
  Linear -> LogSoftMax.
* ``text_cnn``: the reference's text-classification example
  (example/textclassification/TextClassifier.scala): three conv5 stages
  with max pooling over pre-embedded (B, T, embed_dim) input, then a dense
  head.

The children are those of the JAX builders, in order, so a JAX param tree
loads by name (``interop.load_jax``)."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential

__all__ = ["simple_rnn", "lstm_classifier", "birnn_classifier", "text_cnn"]


def simple_rnn(input_size: int, hidden_size: int, output_size: int,
               bptt_truncate: int = 2,
               generator: Optional[torch.Generator] = None) -> Sequential:
    """(B, T, input_size) in, (B, output_size) log-probs of the last step
    out."""
    return Sequential(
        nn.Recurrent(nn.RnnCell(input_size, hidden_size, torch.tanh,
                                generator=generator),
                     bptt_truncate=bptt_truncate, return_sequences=False),
        nn.Linear(hidden_size, output_size, generator=generator),
        nn.LogSoftMax(),
        name="SimpleRNN",
    )


def lstm_classifier(vocab_size: int, embed_dim: int, hidden_size: int,
                    class_num: int,
                    generator: Optional[torch.Generator] = None
                    ) -> Sequential:
    return Sequential(
        nn.LookupTable(vocab_size, embed_dim, generator=generator),
        nn.Recurrent(nn.LSTMCell(embed_dim, hidden_size,
                                 generator=generator),
                     return_sequences=False),
        nn.Linear(hidden_size, class_num, generator=generator),
        nn.LogSoftMax(),
        name="LSTMClassifier",
    )


def birnn_classifier(vocab_size: int, embed_dim: int, hidden_size: int,
                     class_num: int,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequential:
    return Sequential(
        nn.LookupTable(vocab_size, embed_dim, generator=generator),
        # the final state of each direction (forward at T-1, backward at 0)
        nn.BiRecurrent(nn.LSTMCell(embed_dim, hidden_size,
                                   generator=generator),
                       nn.LSTMCell(embed_dim, hidden_size,
                                   generator=generator),
                       return_sequences=False),
        nn.Linear(2 * hidden_size, class_num, generator=generator),
        nn.LogSoftMax(),
        name="BiRNNClassifier",
    )


def text_cnn(seq_len: int, embed_dim: int, class_num: int,
             filters: int = 128,
             generator: Optional[torch.Generator] = None) -> Sequential:
    """(B, seq_len, embed_dim) in; needs seq_len >= 149 (the reference
    uses 500)."""
    m = Sequential(name="TextCNN")
    cin, t = embed_dim, seq_len
    for _ in range(2):
        m.add(nn.TemporalConvolution(cin, filters, 5, generator=generator))
        m.add(nn.ReLU())
        m.add(nn.TemporalMaxPooling(5, 5))
        cin = filters
        t = (t - 4 - 5) // 5 + 1  # valid conv k=5, then pool k=s=5
    if t < 5:
        # t >= 5 after two stages requires t1 >= 29, i.e. seq_len >= 149
        raise ValueError(f"seq_len={seq_len} too short for the 3-stage "
                         f"TextCNN (needs >= 149; reference uses 500)")
    m.add(nn.TemporalConvolution(cin, filters, 5, generator=generator))
    m.add(nn.ReLU())
    t = t - 4
    m.add(nn.TemporalMaxPooling(t, t))
    m.add(nn.Reshape([filters]))
    m.add(nn.Linear(filters, 100, generator=generator))
    m.add(nn.ReLU())
    m.add(nn.Linear(100, class_num, generator=generator))
    m.add(nn.LogSoftMax())
    return m
