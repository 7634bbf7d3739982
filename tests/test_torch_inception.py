"""BASELINE config 4's models in the port against the JAX package, on the
CPU: AlexNet, Inception-v1 (without and with its aux classifiers) and
Inception-v2 (BN-Inception), each loaded from one JAX parameter tree
through ``load_jax``, and the layers of the slice side by side with
their JAX classes.

The full-size models' trees have the JAX init's structure and shapes
(``jax.eval_shape`` of ``model.init``) and are filled from a numpy seed,
each weight U(+-sqrt(6 / fan_in)), each 1-D leaf near its init (BN gamma
1 + 0.1 N(0, 1), biases 0.1 N(0, 1)): running the JAX init itself costs
15-20 s a model on this CPU. ``inception_module``'s trees are the JAX
init's own.

Tolerances, f32: outputs, losses and running statistics atol 1e-4;
parameter gradients max|d| <= 1e-4 * max|g| each (a gradient that is 0
in exact arithmetic, within 1e-6, counts as 0); the layers of the slice
atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu.models.inception import inception_module as jax_module
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax

MODEL_ATOL = 1e-4
GRAD_REL = 1e-4
LAYER_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


def seeded_tree(jm, seed):
    """A param tree of ``jm.init``'s structure and shapes, from a numpy
    seed (see the module docstring)."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        shape = leaf.shape
        if path[-1].key == "weight" and len(shape) >= 2:
            bound = np.sqrt(6.0 / int(np.prod(shape[:-1])))
            return rs.uniform(-bound, bound, shape).astype(np.float32)
        if path[-1].key == "weight":
            return (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def _grad_errors(got: dict, ref: dict) -> dict:
    assert set(got) == set(ref)
    out = {}
    for name, g in got.items():
        r = ref[name].float()
        worst = float((g.float() - r).abs().max())
        out[name] = 0.0 if worst <= 1e-6 else worst / float(r.abs().max())
    return out


def _jax_loss_and_grads(jm, params, state, x, y, training):
    def loss_fn(p):
        out, st = jm.apply(p, state, jnp.asarray(x), training=training)
        return jnn.ClassNLLCriterion()(out, jnp.asarray(y)), (out, st)

    (loss, (out, st)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    return loss, out, _np_tree(st), _np_tree(grads)


# ----------------------------------------------------------------- AlexNet
def test_alexnet_matches_jax():
    """Eval forward at 227 x 227, batch 2, the NLL loss and every
    parameter gradient (dropout is off in eval mode in both packages)."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 227, 227, 3).astype(np.float32)
    y = rs.randint(0, 17, 2).astype(np.int32)
    jm, tm = jax_models.alexnet(17), models.alexnet(17)
    assert [(type(m).__name__, m.name) for m in tm] == [
        (type(m).__name__, m.name) for m in jm._modules]
    params = seeded_tree(jm, 1)
    state = _np_tree(jm.init_state())
    load_jax(tm, params, state)
    jl, jout, _, jg = _jax_loss_and_grads(jm, params, state, x, y, False)
    tm.eval()
    tout = tm(torch.from_numpy(x))
    tl = nn.ClassNLLCriterion()(tout, torch.from_numpy(y))
    tl.backward()
    _close(tout.detach(), jout, MODEL_ATOL)
    _close(tl.detach(), jl, MODEL_ATOL)
    errs = _grad_errors({n: p.grad for n, p in tm.named_parameters()},
                        tensors_from_jax(tm, jg))
    assert len(errs) == 16 and max(errs.values()) <= GRAD_REL, errs


# --------------------------------------------------------------- Inception
def test_inception_v1_no_aux_matches_jax():
    jm, tm = jax_models.inception_v1_no_aux(17), models.inception_v1_no_aux(17)
    assert tm.name == jm.name == "Inception_v1_NoAux"
    params = seeded_tree(jm, 2)
    load_jax(tm, params, _np_tree(jm.init_state()))
    x = np.random.RandomState(2).randn(2, 224, 224, 3).astype(np.float32)
    jout = jm.apply(params, jm.init_state(), jnp.asarray(x))[0]
    with torch.no_grad():
        tout = tm.eval()(torch.from_numpy(x))
    assert tout.shape == (2, 17)
    _close(tout, jout, MODEL_ATOL)


def test_inception_v1_aux_outputs_and_parallel_criterion():
    """(main, aux1, aux2) in eval mode and ParallelCriterion(repeat_target)
    weighted (1.0, 0.3, 0.3), the loss the reference trains it with."""
    jm, tm = jax_models.inception_v1(17), models.inception_v1(17)
    assert [m.name for m in tm] == ["trunk1", "Sequential", "reorder"]
    params = seeded_tree(jm, 3)
    load_jax(tm, params, _np_tree(jm.init_state()))
    rs = np.random.RandomState(3)
    x = rs.randn(2, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 17, 2).astype(np.int32)
    jouts = jm.apply(params, jm.init_state(), jnp.asarray(x))[0]
    with torch.no_grad():
        touts = tm.eval()(torch.from_numpy(x))
    assert len(touts) == len(jouts) == 3
    for got, ref in zip(touts, jouts):
        assert got.shape == (2, 17)
        _close(got, ref, MODEL_ATOL)
    jcrit, tcrit = (jnn.ParallelCriterion(repeat_target=True),
                    nn.ParallelCriterion(repeat_target=True))
    for w in (1.0, 0.3, 0.3):
        jcrit.add(jnn.ClassNLLCriterion(), w)
        tcrit.add(nn.ClassNLLCriterion(), w)
    _close(tcrit(touts, torch.from_numpy(y)),
           jcrit(jouts, jnp.asarray(y)), MODEL_ATOL)


def test_inception_v2_training_forward_matches_jax():
    """Training mode at batch 2: log-probs, NLL loss and the 57 BNs'
    running statistics."""
    jm, tm = jax_models.inception_v2(17), models.inception_v2(17)
    params = seeded_tree(jm, 4)
    state = _np_tree(jm.init_state())
    load_jax(tm, params, state)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 17, 2).astype(np.int32)
    jout, jst = jm.apply(params, state, jnp.asarray(x), training=True)
    tm.train()
    with torch.no_grad():
        tout = tm(torch.from_numpy(x))
    _close(tout, jout, MODEL_ATOL)
    _close(nn.ClassNLLCriterion()(tout, torch.from_numpy(y)),
           jnn.ClassNLLCriterion()(jout, jnp.asarray(y)), MODEL_ATOL)
    ref = tensors_from_jax(tm, params, _np_tree(jst))
    bufs = dict(tm.named_buffers())
    assert len(bufs) == 2 * 57
    for name, buf in bufs.items():
        _close(buf, ref[name], MODEL_ATOL)


# (cin, config) small enough for the JAX init itself: every branch
SMALL_CFG = (8, [[4], [4, 6], [2, 3], [3]])


@pytest.mark.parametrize("with_bn", [False, True])
def test_inception_module_gradients_match_jax(with_bn):
    """One training forward and backward of an inception module at 7 x 7:
    output, every parameter gradient and, with BN, the running stats."""
    jm = jnn.Sequential(jax_module(*SMALL_CFG, with_bn=with_bn))
    tm = nn.Sequential(models.inception_module(*SMALL_CFG, with_bn=with_bn))
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(5)))
    state = _np_tree(jm.init_state())
    load_jax(tm, params, state)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 7, 7, 8).astype(np.float32)
    ct = rs.randn(2, 7, 7, 16).astype(np.float32)

    def fn(p):
        out, st = jm.apply(p, state, jnp.asarray(x), training=True)
        return jnp.sum(out * ct), (out, st)

    (_, (jout, jst)), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tm.train()
    tout = tm(torch.from_numpy(x))
    (tout * torch.from_numpy(ct)).sum().backward()
    _close(tout.detach(), jout, LAYER_ATOL)
    errs = _grad_errors({n: p.grad for n, p in tm.named_parameters()},
                        tensors_from_jax(tm, _np_tree(jg)))
    assert len(errs) == (18 if with_bn else 12) and \
        max(errs.values()) <= GRAD_REL, errs
    ref = tensors_from_jax(tm, params, _np_tree(jst))
    for name, buf in tm.named_buffers():
        _close(buf, ref[name], LAYER_ATOL)


def test_inception_v2_fused_apply_absorbs_all_57_relus():
    """Under ``--fusedBN apply`` every BN absorbs its ReLU, those inside
    the Concat branches too, as in the JAX package; the fused model's
    training forward (the BN kernels' plain twins here) is the plain
    model's."""
    jm = jax_models.inception_v2(17)
    params, state = seeded_tree(jm, 6), _np_tree(jm.init_state())
    plain, fused = models.inception_v2(17), models.inception_v2(17)
    for m in (plain, fused):
        load_jax(m, params, state)
    assert nn.absorb_bn_relu(fused) == 57
    nn.set_bn_fused(fused, "apply")
    bns = [m for m in fused.modules() if isinstance(m, nn.BatchNormalization)]
    assert len(bns) == 57 and all(b.fuse_relu and b.fused == "apply"
                                  for b in bns)
    assert jnn.absorb_bn_relu(jm) == 57
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 224, 224, 3).astype(np.float32))
    with torch.no_grad():
        _close(fused.train()(x), plain.train()(x), MODEL_ATOL)
    for a, b in zip(fused.buffers(), plain.buffers()):
        _close(a, b, MODEL_ATOL)


# --------------------------------------- the slice's layers, side by side
def _layer_pair(kind, arg):
    if kind == "maxpool_ceil":
        k, s, p = arg
        return (jnn.SpatialMaxPooling(k, k, s, s, p, p).ceil(),
                nn.SpatialMaxPooling(k, k, s, s, p, p).ceil())
    if kind == "avgpool":
        k, s, p = arg
        return (jnn.SpatialAveragePooling(k, k, s, s, p, p).ceil(),
                nn.SpatialAveragePooling(k, k, s, s, p, p).ceil())
    if kind == "lrn":
        size, alpha, beta, k = arg
        return (jnn.SpatialCrossMapLRN(size, alpha, beta, k),
                nn.SpatialCrossMapLRN(size, alpha, beta, k))
    raise ValueError(kind)


LAYER_CASES = ([("maxpool_ceil", c) for c in ((3, 2, 0), (3, 1, 1),
                                               (2, 2, 0), (3, 3, 1))]
               + [("avgpool", c) for c in ((5, 3, 0), (3, 2, 1))]
               + [("lrn", c) for c in ((5, 1e-4, 0.75, 1.0),
                                       (4, 0.5, 0.6, 2.0),
                                       (3, 1.0, 0.75, 1.0))])


@pytest.mark.parametrize("kind,arg", LAYER_CASES,
                         ids=[f"{k}-{'-'.join(map(str, a))}"
                              for k, a in LAYER_CASES])
@pytest.mark.parametrize("hw", [(7, 7), (14, 13), (28, 28), (55, 56)])
def test_slice_layers_match_jax(kind, arg, hw):
    jl, tl = _layer_pair(kind, arg)
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 6).astype(np.float32)
    ref = jl.apply({}, jl.init_state(), jnp.asarray(x))[0]
    got = tl(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    _close(got, ref, LAYER_ATOL)


def test_slice_containers_match_jax():
    """Concat on the channel and a spatial axis, nested ConcatTables
    through FlattenTable, the reorder Lambda, and ParallelCriterion with
    and without repeat_target."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 5, 4).astype(np.float32)
    for axis in (-1, 1):
        jc = jnn.Concat(jnn.SpatialConvolution(4, 3, 1, 1),
                        jnn.SpatialConvolution(4, 2, 3, 3, 1, 1, 1, 1),
                        axis=axis) if axis == -1 else jnn.Concat(
            jnn.Identity(), jnn.ReLU(), axis=axis)
        tc = nn.Concat(nn.SpatialConvolution(4, 3, 1, 1),
                       nn.SpatialConvolution(4, 2, 3, 3, 1, 1, 1, 1),
                       axis=axis) if axis == -1 else nn.Concat(
            nn.Identity(), nn.ReLU(), axis=axis)
        p = _np_tree(jc.init(jax.random.PRNGKey(axis + 2)))
        load_jax(tc, p)
        _close(tc(torch.from_numpy(x)).detach(),
               jc.apply(p, jc.init_state(), jnp.asarray(x))[0], LAYER_ATOL)
    jt = jnn.Sequential(jnn.ConcatTable(
        jnn.ConcatTable(jnn.Identity(), jnn.ReLU()), jnn.Tanh()),
        jnn.FlattenTable(), jnn.Lambda(lambda t: (t[0], t[2], t[1])))
    tt = nn.Sequential(nn.ConcatTable(
        nn.ConcatTable(nn.Identity(), nn.ReLU()), nn.Tanh()),
        nn.FlattenTable(), nn.Lambda(lambda t: (t[0], t[2], t[1])))
    jouts = jt.apply(jt.init(jax.random.PRNGKey(0)), jt.init_state(),
                     jnp.asarray(x))[0]
    touts = tt(torch.from_numpy(x))
    assert len(touts) == len(jouts) == 3
    for a, b in zip(touts, jouts):
        _close(a, b, LAYER_ATOL)
    logp = [np.log(rs.dirichlet(np.ones(5), 3)).astype(np.float32)
            for _ in range(3)]
    y = rs.randint(0, 5, 3).astype(np.int32)
    for repeat in (True, False):
        jc, tc = (jnn.ParallelCriterion(repeat_target=repeat),
                  nn.ParallelCriterion(repeat_target=repeat))
        for w in (1.0, 0.3, 0.7):
            jc.add(jnn.ClassNLLCriterion(), w)
            tc.add(nn.ClassNLLCriterion(), w)
        tgt = y if repeat else [y, (y + 1) % 5, (y + 2) % 5]
        _close(tc([torch.from_numpy(a) for a in logp],
                  torch.from_numpy(y) if repeat else
                  [torch.from_numpy(t) for t in tgt]),
               jc([jnp.asarray(a) for a in logp],
                  jnp.asarray(y) if repeat else
                  [jnp.asarray(t) for t in tgt]), LAYER_ATOL)
