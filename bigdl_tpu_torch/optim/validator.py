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


@torch.no_grad()
def run_evaluation(model: torch.nn.Module, dataset,
                   methods: Sequence[ValidationMethod], device) -> list:
    """One pass over ``dataset`` in eval mode, each method's (value,
    count) summed over the batches; the model's train/eval mode is
    restored after."""
    was_training = model.training
    model.eval()
    try:
        sums = None
        for x, y in dataset:
            x = torch.as_tensor(np.asarray(x)).to(device)
            y = torch.as_tensor(np.asarray(y)).to(device)
            out = model(x)
            stats = [(float(v), int(c)) for v, c in
                     (m.stats(out, y) for m in methods)]
            sums = stats if sums is None else [
                (a + v, b + c) for (a, b), (v, c) in zip(sums, stats)]
    finally:
        model.train(was_training)
    return [m.to_result(v, c) for m, (v, c) in zip(methods, sums or [])]


class Validator:
    """``Validator(model, dataset).test(methods)``: the model carries its
    parameters and BN running statistics, so ``test`` takes only the
    methods (the JAX package's also takes the param and state trees)."""

    def __init__(self, model: torch.nn.Module, dataset, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = dataset

    def test(self, methods: Sequence[ValidationMethod]) -> list:
        return run_evaluation(self.model, self.dataset, methods, self.device)
