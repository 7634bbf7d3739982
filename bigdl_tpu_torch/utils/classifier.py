"""Batched inference facade (counterpart of
``bigdl_tpu/utils/classifier.py``; reference utils/DLClassifier.scala:
36-136, a Spark-ML Transformer that batches rows, runs the forward and
emits argmax predictions).

``Classifier(module)`` wraps an eval-mode module on its device and streams
any array or iterable through it in fixed batches of ``batch_size``: the
tail is padded by repeating its last row, and the padding's outputs are
cut, so the device sees one batch shape (as the JAX version's one jitted
shape).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from bigdl_tpu_torch.core.module import resolve_device

__all__ = ["Classifier"]


class Classifier:
    """``Classifier(module)(x)`` -> class ids. ``batch_size`` fixes the
    forward's batch; ``device`` is CUDA unless the caller asks for the
    CPU. The module is moved there and put in eval mode."""

    def __init__(self, module, batch_size: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.batch_size = int(batch_size)

    @torch.no_grad()
    def _fwd(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return self.module(x).float().cpu().numpy()

    def _out_shape(self, feat_shape) -> tuple:
        """The output's per-row shape, from a forward over ``meta`` tensors
        (nothing is computed; the JAX version's ``eval_shape``)."""
        from bigdl_tpu_torch.utils.file import _meta_shell

        shell = _meta_shell(self.module).to("meta")
        with torch.no_grad():
            y = shell(torch.empty((self.batch_size,) + tuple(feat_shape),
                                  dtype=torch.float32, device="meta"))
        return tuple(y.shape[1:])

    def predict_scores(self, x) -> np.ndarray:
        """Raw model outputs (e.g. log-probs) for every row of x."""
        n = len(x)
        if n == 0:
            feat_shape = np.asarray(x).shape[1:]
            if not feat_shape:
                # a plain empty list carries no feature dims: nothing to
                # learn an output shape from
                return np.zeros((0,), np.float32)
            return np.zeros((0,) + self._out_shape(feat_shape))
        outs = []
        for i in range(0, n, self.batch_size):
            chunk = np.asarray(x[i:i + self.batch_size])
            take = len(chunk)
            pad = self.batch_size - take
            if pad > 0:  # pad the tail so the batch shape is fixed
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            outs.append(self._fwd(chunk)[:take])
        return np.concatenate(outs)

    def predict(self, x) -> np.ndarray:
        """Argmax class ids (reference DLClassifier's prediction column)."""
        scores = self.predict_scores(x)
        if len(scores) == 0:
            return np.zeros((0,), np.int64)
        return np.argmax(scores, axis=-1)

    def predict_iter(self, batches: Iterable[Any]) -> Iterable[np.ndarray]:
        """Stream predictions over an iterator of feature batches."""
        for b in batches:
            feats = b.input if hasattr(b, "input") else b
            yield self.predict(np.asarray(feats))

    def __call__(self, x) -> np.ndarray:
        return self.predict(x)
