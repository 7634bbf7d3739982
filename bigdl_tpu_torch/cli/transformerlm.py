"""Transformer LM training on the GPU (counterpart of
``bigdl_tpu/cli/transformerlm.py``)::

    python -m bigdl_tpu_torch.cli.transformerlm train -f data/ \\
        --seqLength 256 --dModel 256 --numLayers 4 --flash --remat

    python -m bigdl_tpu_torch.cli.transformerlm generate -f data/ \\
        --model CKPT --seqLength 256 --dModel 256 --numLayers 4 \\
        --prompt "the " --numTokens 64

``train`` reads ``input.txt`` from the folder, trains next-token
prediction over fixed windows (or, with ``--packed``, over sentences
packed into rows with segment-masked attention and a boundary-masked
loss) and prints the held-out perplexity. ``--flash`` runs attention
forward and backward through the CUDA flash kernels. ``generate`` loads a
checkpoint (the port's or the JAX package's) into an LM of the given
widths, with the dictionary of the folder's corpus, and samples from a
prompt with top-k sampling (greedy at temperature 0).
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
    ge = sub.add_parser("generate",
                        help="sample from a trained checkpoint (KV-cache "
                             "decode)")
    common.add_test_args(ge)
    for flag, dv in (("--vocabSize", 4000), ("--seqLength", 128),
                     ("--dModel", 128), ("--numLayers", 2),
                     ("--numHeads", 4)):
        ge.add_argument(flag, type=int, default=dv)
    ge.add_argument("--prompt", default="the ",
                    help="prompt text (tokenized with the corpus dict)")
    ge.add_argument("--numTokens", type=int, default=64)
    ge.add_argument("--temperature", type=float, default=0.8)
    ge.add_argument("--topK", type=int, default=40)
    ge.add_argument("--seed", type=int, default=0)
    return p


def _build_lm(args, vocab: int):
    import torch

    from bigdl_tpu_torch.models import transformer_lm

    return transformer_lm(
        vocab, d_model=args.dModel, num_layers=args.numLayers,
        num_heads=args.numHeads, max_len=args.seqLength,
        dropout=getattr(args, "dropout", 0.0),
        attn_impl="flash" if getattr(args, "flash", False) else None,
        remat=getattr(args, "remat", False),
        compute_dtype=torch.bfloat16 if getattr(args, "bf16", False)
        else None, generator=torch.Generator().manual_seed(args.seed))


def _generate(args, d):
    """Sample ``--numTokens`` words after ``--prompt`` from the checkpoint
    ``--model``; prints the prompt and the words."""
    import torch

    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.dataset import tokenize

    device = resolve_device(args.platform)
    model = common.load_trained(_build_lm(args, len(d)), args.model)
    model = model.to(device).eval()
    prompt = np.asarray([d.ids(tokenize(args.prompt))], np.int64)
    if prompt.shape[1] == 0:
        raise SystemExit("empty prompt after tokenization")
    out = model.generate(prompt, args.numTokens,
                         temperature=args.temperature, top_k=args.topK,
                         generator=torch.Generator().manual_seed(args.seed))
    words = [d.id2word.get(int(i), "<unk>") for i in out[0].tolist()]
    print(args.prompt + " ".join(words))
    return words


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
    args = parser.parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import BatchDataSet, Dictionary, tokenize

    if args.cmd != "generate":
        common.install_fault_plan(args)
        common.install_observability(args)
    with open(os.path.join(args.folder, "input.txt")) as f:
        tokens = tokenize(f.read())
    d = Dictionary([tokens], vocab_size=args.vocabSize)
    if args.cmd == "generate":
        return _generate(args, d)
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

    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())

    def _make():  # each attempt from the seed: a failed one moved on
        train = BatchDataSet(x, y, args.batchSize, shuffle=True)
        opt = common.build_optimizer(_build_lm(args, len(d)), train, crit,
                                     args)
        opt.accum_steps = max(1, args.accumSteps)
        return opt

    trained = common.run_optimize(_make, args)

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

    class PackedLM(tnn.Module):
        """Unstacks (n, 2, s) rows into (tokens, segments) for the LM."""

        def __init__(self):
            super().__init__()
            self.lm = _build_lm(args, len(d))

        def forward(self, x, seed=None):
            return self.lm((x[:, 0], x[:, 1]), seed=seed)

    base = PackedNLLCriterion()

    def crit(logp, y):
        return base(logp, (y[:, 0].long(), y[:, 1]))

    def _make():  # each attempt from the seed: a failed one moved on
        train = BatchDataSet(f_tr, l_tr, args.batchSize, shuffle=True)
        opt = common.build_optimizer(PackedLM(), train, crit, args)
        opt.accum_steps = max(1, args.accumSteps)
        return opt

    trained = common.run_optimize(_make, args)

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
