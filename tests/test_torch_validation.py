"""The port's Top-k accuracy (bigdl_tpu_torch.optim.validation) against the
JAX package's, on scores that tie at the k-th place.

``jax.lax.top_k`` keeps the lowest indices among equal scores and orders
-0.0 below +0.0; the port counts a record as correct under the same rule.
The counts are integers, so they must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import validation as jval
from bigdl_tpu_torch.optim import validation as tval


def _both(scores, labels):
    jv = [int(v) for v in jval.Top5Accuracy().stats(
        jnp.asarray(scores), jnp.asarray(labels))]
    tv = [int(v) for v in tval.Top5Accuracy().stats(
        torch.from_numpy(scores), torch.from_numpy(labels))]
    return jv, tv


def test_top5_zero_block_counts_no_tie_past_the_fifth_index():
    scores = np.zeros((4, 10), np.float32)
    labels = np.array([7, 7, 7, 7], np.int32)
    jv, tv = _both(scores, labels)
    assert jv == tv == [0, 4]
    jv, tv = _both(scores, np.array([0, 4, 5, 9], np.int32))
    assert jv == tv == [2, 4]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top5_tied_rows_on_a_half_grid(seed, dtype):
    rs = np.random.RandomState(seed)
    scores = (rs.randint(-4, 5, (64, 10)) * 0.5).astype(dtype)
    labels = rs.randint(0, 10, 64).astype(np.int32)
    jv, tv = _both(scores, labels)
    assert jv == tv


def test_top5_orders_negative_zero_below_positive_zero():
    # +0.0 at odd indices, -0.0 at even: the top 5 are the five +0.0
    scores = np.array([[-0.0, 0.0] * 5, [0.0, -0.0] * 5,
                       [-0.0] * 6 + [0.0] * 4, [1.0] + [-0.0] * 9],
                      np.float32)
    labels = np.array([0, 0, 5, 9], np.int32)
    jv, tv = _both(scores, labels)
    assert jv == tv == [1, 4]
    jv, tv = _both(scores, np.array([1, 8, 9, 4], np.int32))
    assert jv == tv == [4, 4]
