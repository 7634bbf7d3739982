"""The SimpleRNN word-level language model (counterpart of
``bigdl_tpu/cli/rnn.py``; reference models/rnn/{Train,Test,Utils}.scala)::

    python -m bigdl_tpu_torch.cli.rnn train -f DIR [--vocabSize 4000] \\
        [--seqLength 20] [--hiddenSize 40] [-b 128] [--maxEpoch 5] \\
        [--platform cpu]

DIR holds ``input.txt``. Its words (``dataset.text.tokenize``) are mapped
to ids by a dictionary of the ``--vocabSize`` most frequent ones, cut
into windows of ``--seqLength`` ids, each labelled with the id after it,
and the tail's windows (a tenth of them, at most 512) are held out. The
model reads ids through ``LookupTable(vocab, vocab)`` (a row lookup is the
product of a one-hot input with the table, which the reference feeds)
into ``simple_rnn`` (truncated BPTT every 2 steps) and trains on the
next-word NLL with SGD at the common flags' defaults. The run ends by
printing ``perplexity is X`` over the held-out windows.
"""

from __future__ import annotations

import argparse
import math
import os

from bigdl_tpu_torch.cli import common

__all__ = ["main"]


def _windows(ids, seq_len: int):
    """(windows of ``seq_len`` ids, the id after each) as int32 arrays."""
    import numpy as np

    xs, ys = [], []
    for i in range(0, len(ids) - seq_len):
        xs.append(ids[i:i + seq_len])
        ys.append(ids[i + seq_len])
    return np.asarray(xs, np.int32), np.asarray(ys, np.int32)


def main(argv=None):
    common.setup_logging()
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.rnn")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    common.add_train_args(tr)
    tr.add_argument("--vocabSize", type=int, default=4000)
    tr.add_argument("--seqLength", type=int, default=20)
    tr.add_argument("--hiddenSize", type=int, default=40)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential, resolve_device
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.dataset.text import Dictionary, tokenize
    from bigdl_tpu_torch.models import simple_rnn

    common.apply_platform(args)  # refuse before reading the data
    device = resolve_device(args.platform)
    with open(os.path.join(args.folder, "input.txt")) as f:
        tokens = tokenize(f.read())
    d = Dictionary([tokens], vocab_size=args.vocabSize)
    ids = np.asarray(d.ids(tokens), np.int32)
    x, y = _windows(ids, args.seqLength)
    n_held = min(512, max(1, len(x) // 10))
    x, y, x_val, y_val = (x[:-n_held], y[:-n_held],
                          x[-n_held:], y[-n_held:])
    vocab = len(d)

    def _make():  # each attempt from the seed: a failed one moved on
        g = torch.Generator().manual_seed(args.seed)
        model = Sequential(
            nn.LookupTable(vocab, vocab, generator=g),
            *simple_rnn(vocab, args.hiddenSize, vocab,
                        generator=g).children(),
            name="SimpleRNN-LM",
        )
        train = BatchDataSet(x, y, args.batchSize, shuffle=True)
        return common.build_optimizer(model, train, nn.ClassNLLCriterion(),
                                      args)

    trained = common.run_optimize(_make, args)
    model = trained.module
    model.eval()
    with torch.no_grad():
        logp = model(torch.from_numpy(x_val).to(device)).float().cpu()
    nll = -np.mean(logp.numpy()[np.arange(len(y_val)), y_val])
    # math.exp raises OverflowError past nll ~709, as the JAX CLI does
    print(f"perplexity is {math.exp(nll):.2f}")
    return trained


if __name__ == "__main__":
    main()
