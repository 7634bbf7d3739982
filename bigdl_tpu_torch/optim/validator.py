"""Model evaluation (counterpart of ``bigdl_tpu/optim/validator.py``;
reference optim/Validator.scala). The Optimizer's in-training validation
runs :func:`run_evaluation` too, so evaluation lives in one place."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.module import resolve_device
from bigdl_tpu_torch.optim.validation import ValidationMethod

__all__ = ["Validator", "run_evaluation"]


def _rank_rows(n: int, rank: int, ranks: int) -> slice:
    """Rank ``rank``'s rows of an n-row batch split as evenly as it goes."""
    return slice(n * rank // ranks, n * (rank + 1) // ranks)


@torch.no_grad()
def run_evaluation(model: torch.nn.Module, dataset,
                   methods: Sequence[ValidationMethod], device,
                   strategy=None) -> list:
    """One pass over ``dataset`` in eval mode, each method's (value,
    count) summed over the batches; the model's train/eval mode is
    restored after. Under a data-parallel ``strategy`` each rank takes
    its rows of every batch (none when the dataset already yields its
    part: ``parallel.feeds_rank_part``), and the sums are summed over the
    ranks, so every rank gets the whole dataset's results."""
    was_training = model.training
    model.eval()
    split = None
    if strategy is not None and strategy.world > 1:
        from bigdl_tpu_torch.parallel import feeds_rank_part
        if not feeds_rank_part(dataset):
            split = (strategy.rank, strategy.world)
    try:
        sums = [(0.0, 0)] * len(methods)
        seen = False
        for x, y in dataset:
            if split is not None:
                rows = _rank_rows(len(x), *split)
                x, y = x[rows], y[rows]
                if len(x) == 0:
                    continue
            x = torch.as_tensor(np.asarray(x)).to(device)
            y = torch.as_tensor(np.asarray(y)).to(device)
            out = model(x)
            stats = [(float(v), int(c)) for v, c in
                     (m.stats(out, y) for m in methods)]
            sums = [(a + v, b + c) for (a, b), (v, c) in zip(sums, stats)]
            seen = True
    finally:
        model.train(was_training)
    if strategy is not None:
        flat = strategy.sum_over_ranks(
            [u for vc in sums for u in vc] + [float(seen)], device)
        seen = flat[-1] > 0
        sums = [(flat[2 * i], int(round(flat[2 * i + 1])))
                for i in range(len(methods))]
    if not seen:
        return []
    return [m.to_result(v, c) for m, (v, c) in zip(methods, sums)]


class Validator:
    """``Validator(model, dataset).test(methods)``: the model carries its
    parameters and BN running statistics, so ``test`` takes only the
    methods (the JAX package's also takes the param and state trees).
    ``strategy`` (a ``DataParallel``) splits each batch over the ranks
    and sums the counts, so Top-1 and Top-5 are the whole dataset's."""

    def __init__(self, model: torch.nn.Module, dataset, device=None,
                 strategy=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.strategy = strategy

    def test(self, methods: Sequence[ValidationMethod]) -> list:
        return run_evaluation(self.model, self.dataset, methods, self.device,
                              self.strategy)
