"""Transformer LM training on the GPU (counterpart of
``bigdl_tpu/cli/transformerlm.py``)::

    python -m bigdl_tpu_torch.cli.transformerlm train -f data/ \\
        --seqLength 256 --dModel 256 --numLayers 4 --flash --remat

reads ``input.txt`` from the folder, trains next-token prediction over
fixed windows (or, with ``--packed``, over sentences packed into rows with
segment-masked attention and a boundary-masked loss) and prints the
held-out perplexity. ``--flash`` runs attention forward and backward
through the CUDA flash kernels. ``generate`` needs the checkpoint reader
and is not ported yet.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from bigdl_tpu_torch.cli import common

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.transformerlm")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    common.add_train_args(tr)
    tr.add_argument("--vocabSize", type=int, default=4000)
    tr.add_argument("--seqLength", type=int, default=128)
    tr.add_argument("--dModel", type=int, default=128)
    tr.add_argument("--numLayers", type=int, default=2)
    tr.add_argument("--numHeads", type=int, default=4)
    tr.add_argument("--dropout", type=float, default=0.0)
    tr.add_argument("--flash", action="store_true",
                    help="attention through the CUDA flash kernels")
    tr.add_argument("--remat", nargs="?", const="full", default=False,
                    choices=["full", "dots"],
                    help="recompute each block in the backward: 'full' "
                         "keeps nothing, 'dots' keeps the weight "
                         "projections' outputs")
    tr.add_argument("--bf16", action="store_true")
    tr.add_argument("--accumSteps", type=int, default=1)
    tr.add_argument("--packed", action="store_true",
                    help="sentence-split the corpus and pack documents into "
                         "rows (segment-masked attention, boundary-masked "
                         "loss) instead of fixed windows")
    sub.add_parser("generate", add_help=False)
    return p


def _build_lm(args, vocab: int):
    import torch

    from bigdl_tpu_torch.models import transformer_lm

    return transformer_lm(
        vocab, d_model=args.dModel, num_layers=args.numLayers,
        num_heads=args.numHeads, max_len=args.seqLength,
        dropout=args.dropout, attn_impl="flash" if args.flash else None,
        remat=args.remat,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        generator=torch.Generator().manual_seed(args.seed))


def _clamp_batch(args, n: int, what: str) -> None:
    if n < args.batchSize:
        # BatchDataSet drops the short remainder: without the clamp a small
        # corpus would train for zero steps
        print(f"warning: only {n} {what} < batchSize {args.batchSize}; "
              f"clamping batchSize to {n}")
        args.batchSize = n


def _perplexity(nll: float) -> str:
    """exp(mean NLL) as the JAX package prints it; where exp overflows
    (a mean NLL past ~709, as a wide LM with the reference's N(0, 1)
    embedding gives after a few steps, where the JAX CLI raises
    OverflowError) "inf" and the NLL itself."""
    if nll < math.log(float.fromhex("0x1.fffffffffffffp+1023")):
        return f"{math.exp(nll):.2f}"
    return f"inf (mean held-out nll {nll:.4f} overflows exp)"


def _logp_chunks(module, x, batch: int):
    """Held-out log-probs in chunks of ``batch`` rows, without grad."""
    import torch

    module.eval()
    dev = next(module.parameters()).device
    with torch.no_grad():
        for i in range(0, len(x), batch):
            yield i, module(torch.from_numpy(x[i:i + batch]).to(dev))


def main(argv=None):
    common.setup_logging()
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd == "generate":
        raise SystemExit("transformerlm generate samples from a checkpoint: "
                         "it comes with the checkpoint reader (ROADMAP.md "
                         "queue 1 item 1) and is not in the PyTorch port yet")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)} (flags of "
                     f"features not in the PyTorch port yet: see ROADMAP.md "
                     f"queue 1)")

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import BatchDataSet, Dictionary, tokenize

    with open(os.path.join(args.folder, "input.txt")) as f:
        tokens = tokenize(f.read())
    d = Dictionary([tokens], vocab_size=args.vocabSize)
    if args.packed:
        return _train_packed(args, d, tokens)
    ids = np.asarray(d.ids(tokens), np.int32)

    # non-overlapping next-token windows: x = w[:-1], y = w[1:]
    s = args.seqLength + 1
    n_win = len(ids) // s
    if n_win < 2:
        raise SystemExit(f"corpus too small: {len(ids)} tokens for "
                         f"seqLength {args.seqLength}")
    w = ids[: n_win * s].reshape(n_win, s)
    x, y = w[:, :-1], w[:, 1:]
    n_held = max(1, n_win // 10)
    x, y, x_val, y_val = x[:-n_held], y[:-n_held], x[-n_held:], y[-n_held:]
    _clamp_batch(args, len(x), "training windows")

    model = _build_lm(args, len(d))
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    train = BatchDataSet(x, y, args.batchSize, shuffle=True)

    opt = common.build_optimizer(model, train, crit, args)
    opt.accum_steps = max(1, args.accumSteps)
    trained = opt.optimize()

    nll_sum = 0.0
    for i, logp in _logp_chunks(trained.module, x_val, args.batchSize):
        lp = logp.float().cpu().numpy()
        yv = y_val[i:i + len(lp)]
        nll_sum -= np.take_along_axis(lp, yv[..., None], axis=-1).sum()
    print(f"perplexity is {_perplexity(nll_sum / y_val.size)}")
    return trained


def _train_packed(args, d, tokens):
    """Packed-document training: sentences (split at ".") become documents
    packed into fixed rows; attention is segment-masked and the loss skips
    document boundaries. The Optimizer sees plain arrays: features stack
    (tokens | segments) and labels (targets | weights) along axis 1."""
    import torch
    from torch import nn as tnn

    from bigdl_tpu_torch.dataset import BatchDataSet, pack_sequences
    from bigdl_tpu_torch.models import PackedNLLCriterion, packed_lm_targets

    ids = d.ids(tokens)
    period = d.word2id.get(".")
    docs, cur = [], []
    if period is not None:
        for t in ids:
            cur.append(t)
            if t == period:
                docs.append(cur)
                cur = []
        if cur:
            docs.append(cur)
    else:  # no "." in the corpus: fixed-size pseudo-documents
        step = max(args.seqLength // 4, 8)
        docs = [ids[i:i + step] for i in range(0, len(ids), step)]
    toks, segs = pack_sequences(docs, args.seqLength)
    if len(toks) < 2:
        raise SystemExit(f"corpus too small to pack: {len(docs)} docs "
                         f"-> {len(toks)} rows")
    tgt, w = packed_lm_targets(torch.from_numpy(toks), torch.from_numpy(segs))
    feats = np.stack([toks, segs], axis=1)  # (n, 2, s) int32
    labels = np.stack([tgt.numpy().astype(np.float32), w.numpy()], axis=1)
    n_held = max(1, len(feats) // 10)
    f_tr, f_val = feats[:-n_held], feats[-n_held:]
    l_tr, l_val = labels[:-n_held], labels[-n_held:]
    _clamp_batch(args, len(f_tr), "packed rows")

    lm = _build_lm(args, len(d))

    class PackedLM(tnn.Module):
        """Unstacks (n, 2, s) rows into (tokens, segments) for the LM."""

        def __init__(self):
            super().__init__()
            self.lm = lm

        def forward(self, x, seed=None):
            return self.lm((x[:, 0], x[:, 1]), seed=seed)

    base = PackedNLLCriterion()

    def crit(logp, y):
        return base(logp, (y[:, 0].long(), y[:, 1]))

    train = BatchDataSet(f_tr, l_tr, args.batchSize, shuffle=True)

    opt = common.build_optimizer(PackedLM(), train, crit, args)
    opt.accum_steps = max(1, args.accumSteps)
    trained = opt.optimize()

    nll_sum, live = 0.0, float(l_val[:, 1].sum())
    for i, logp in _logp_chunks(trained.module, f_val, args.batchSize):
        lp = logp.float().cpu().numpy()
        lv = l_val[i:i + len(lp)]
        tv, wv = lv[:, 0].astype(np.int64), lv[:, 1]
        nll_sum -= (np.take_along_axis(lp, tv[..., None], axis=-1)[..., 0]
                    * wv).sum()
    print(f"packed perplexity is {_perplexity(nll_sum / max(live, 1.0))} "
          f"({int(live)} live targets)")
    return trained


if __name__ == "__main__":
    main()
