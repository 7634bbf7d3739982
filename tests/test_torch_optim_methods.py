"""The port's optimization methods, schedules, clipping, ``max_score`` and
``Perplexity`` against the JAX package's, on the CPU.

Each method runs 20 updates from the same numpy-seeded params and
gradients on both sides, the epoch advanced every 5; the rate before each
update, the params and every state leaf are compared. Tolerances: f32
throughout, 1e-5 relative (atol 1e-6 for values near 0); the same
arithmetic in other op orders (fused multiply-adds) differs by a few ulps
a step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import optim as joptim
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim.method import clip_by_global_norm as jclip_norm
from bigdl_tpu.optim.method import clip_by_value as jclip_value
from bigdl_tpu.optim.validation import Perplexity as JaxPerplexity
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.optim import schedules as tsched

RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}

CASES = {
    "sgd_momentum_poly": lambda m, s: m.SGD(
        0.1, momentum=0.9, weight_decay=0.01, schedule=s.Poly(0.5, 30)),
    "sgd_nesterov_step": lambda m, s: m.SGD(
        0.1, momentum=0.9, dampening=0.0, nesterov=True,
        schedule=s.Step(5, 0.5)),
    "sgd_per_param_epoch_decay": lambda m, s: m.SGD(
        0.1, schedule=s.EpochDecay(lambda e: 0.9 ** e),
        learning_rates={"a": 0.5, "b": 2.0, "c": 1.0},
        weight_decays={"a": 0.01, "b": 0.0, "c": 0.1}),
    "sgd_epoch_schedule": lambda m, s: m.SGD(
        0.1, momentum=0.9, schedule=s.EpochSchedule(
            [s.Regime(1, 1, 0.2), s.Regime(2, 3, 0.05)])),
    "sgd_epoch_step": lambda m, s: m.SGD(
        0.1, momentum=0.5, schedule=s.EpochStep(2, 0.5)),
    "adagrad": lambda m, s: m.Adagrad(0.1, lr_decay=0.01,
                                      weight_decay=0.01),
    "adam_warmup_cosine": lambda m, s: m.Adam(
        0.01, weight_decay=0.01,
        schedule=s.Warmup(5, s.CosineAnnealing(20, 0.1))),
    "adam_default": lambda m, s: m.Adam(0.01, schedule=s.Default(0.05)),
    "adamw_warmup": lambda m, s: m.AdamW(0.01, weight_decay=0.01,
                                         schedule=s.Warmup(5)),
    "lamb_step": lambda m, s: m.LAMB(0.01, weight_decay=0.01,
                                     schedule=s.Step(5, 0.5)),
    "lars_poly": lambda m, s: m.LARS(0.1, weight_decay=0.01,
                                     schedule=s.Poly(1.0, 25)),
    "rmsprop": lambda m, s: m.RMSprop(0.01),
    "ema_sgd": lambda m, s: m.EMA(m.SGD(0.1, momentum=0.9), 0.9),
}


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_method_and_schedule_match_jax_over_20_updates(case):
    rs = np.random.RandomState(0)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jm, tm = CASES[case](joptim, jsched), CASES[case](toptim, tsched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jm.init(jp), tm.init(tp)
    ptrs = {k: t.data_ptr() for k, t in _flat(ts).items()}
    for step in range(20):
        js = jm.set_epoch(js, 1 + step // 5)
        assert tm.set_epoch(ts, 1 + step // 5) is ts
        jr, tr = jm.learning_rate(js), tm.learning_rate(ts)
        assert (jr is None) == (tr is None)
        if jr is not None:
            _close(tr, jr, f"rate at step {step}")
        g = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = jm.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        assert tm.update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                         tp) is ts
    for k in SHAPES:
        _close(tp[k], jp[k], f"param {k}")
    jflat, tflat = _flat(js), _flat(ts)
    assert set(jflat) == set(tflat)
    for k in jflat:
        _close(tflat[k], jflat[k], f"state {k}")
    # every state tensor was updated in place (a captured step sees them)
    assert {k: t.data_ptr() for k, t in _flat(ts).items()} == ptrs


@pytest.mark.parametrize("name", ["Default", "Poly", "Step", "EpochDecay",
                                  "EpochStep", "EpochSchedule",
                                  "CosineAnnealing", "Warmup"])
def test_schedules_match_jax(name):
    """Every schedule at steps 0..40 and epochs 0..6, the counters as 0-d
    f32 tensors (as the state holds them); the result is a 0-d f32
    tensor."""
    make = {
        "Default": lambda s: s.Default(0.1),
        "Poly": lambda s: s.Poly(2.0, 30),
        "Step": lambda s: s.Step(7, 0.3),
        "EpochDecay": lambda s: s.EpochDecay(lambda e: 1.0 / (1.0 + e)),
        "EpochStep": lambda s: s.EpochStep(2, 0.1),
        "EpochSchedule": lambda s: s.EpochSchedule(
            [s.Regime(0, 1, 0.3), s.Regime(2, 4, 0.03),
             s.Regime(4, 10 ** 9, 0.003)]),
        "CosineAnnealing": lambda s: s.CosineAnnealing(25, 0.05),
        "Warmup": lambda s: s.Warmup(8, s.Poly(1.0, 20)),
    }[name]
    ours, theirs = make(tsched), make(jsched)
    for step in range(0, 41, 3):
        for epoch in range(7):
            got = ours(0.5, torch.tensor(float(step)),
                       torch.tensor(float(epoch)))
            assert got.dtype == torch.float32 and got.dim() == 0
            ref = theirs(0.5, jnp.float32(step), jnp.float32(epoch))
            _close(got, ref, f"{name} at step {step}, epoch {epoch}")


@pytest.mark.parametrize("clip", ["norm", "value"])
def test_clipping_matches_jax(clip):
    rs = np.random.RandomState(1)
    g = {k: rs.randn(*s).astype(np.float32) * 3 for k, s in SHAPES.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    if clip == "norm":
        got, norm = toptim.clip_by_global_norm(tg, 1.5)
        ref, jnorm = jclip_norm(jg, 1.5)
        _close(norm, jnorm, "norm")
    else:
        got, ref = toptim.clip_by_value(tg, -0.5, 0.7), jclip_value(
            jg, -0.5, 0.7)
    for k in SHAPES:
        _close(got[k], ref[k], k)


def test_max_score_and_perplexity_match_jax():
    for v in (0.5, 0.9):
        ours, theirs = toptim.Trigger.max_score(v), joptim.Trigger.max_score(v)
        for s in ({}, {"val_score": 0.4}, {"val_score": 0.5},
                  {"val_score": 0.95}):
            assert ours(s) == theirs(s)
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 5, 7).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    y = rs.randint(0, 7, (3, 5)).astype(np.int32)
    w = (rs.rand(3, 5) > 0.3).astype(np.float32)
    for target in ((y,), (y, w)):
        t = tuple(torch.from_numpy(a) for a in target)
        j = tuple(jnp.asarray(a) for a in target)
        ov, oc = toptim.Perplexity().stats(torch.from_numpy(logp),
                                           t if len(t) > 1 else t[0])
        jv, jc = JaxPerplexity().stats(jnp.asarray(logp),
                                       j if len(j) > 1 else j[0])
        _close(ov, jv, "nll sum")
        _close(oc, jc, "count")
        ours = toptim.Perplexity().to_result(ov, oc)
        ref = JaxPerplexity().to_result(jv, jc)
        assert ours.result()[0] == pytest.approx(ref.result()[0], rel=1e-5)
        assert (ours + ours).result()[1] == 2 * ours.result()[1]
    assert repr(ours).startswith("PerplexityResult(")
