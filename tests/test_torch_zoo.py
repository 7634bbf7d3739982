"""The port's layer zoo and criteria against the JAX package's, on the CPU.

One parametrised parity test per file of the JAX zoo (activation,
linear, structural, criterion, conv, pool, norm), each class a case with
arguments from the JAX package's own tests. A case builds the JAX module,
initialises it, and loads that one tree into the port's module through
``load_jax`` (strict: every parameter and buffer by name, converted by the
module's ``from_jax_leaf`` where its layout differs). Inputs are numpy
draws from a seed. Compared, f32, atol 1e-5: the eval forward, and under
one random cotangent the gradient of every float input and every
parameter; for a criterion the loss and d(loss)/d(input). Then the
stated differences: RReLU's hash draws, the LRN window at an even size,
MultiLabelMargin's padding rule, SpatialZeroPadding's crop; each converted
layout's round trip; the core bases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu import nn as jnn
from bigdl_tpu.core import module as jcore
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core import module as core
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=ATOL, err_msg=what)


def _module_parity(jm, tm, inp, seed=0):
    """Forward and gradients of a JAX module and the port's loaded from
    its init tree, eval mode."""
    params = _np(jm.init(jax.random.PRNGKey(seed)))
    state = _np(jm.init_state())
    load_jax(tm, params, state)
    tm.eval()
    leaves, treedef = jax.tree_util.tree_flatten(inp)
    flt = [i for i, a in enumerate(leaves) if _is_float(a)]

    def jfn(p, fl):
        ls = [jnp.asarray(a) for a in leaves]
        for i, v in zip(flt, fl):
            ls[i] = v
        return jm.apply(p, state, jax.tree_util.tree_unflatten(treedef, ls),
                        training=False)[0]

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out, vjp = jax.vjp(jfn, jp, [jnp.asarray(leaves[i]) for i in flt])
    outs = jax.tree_util.tree_leaves(out)
    rs = np.random.RandomState(seed + 1)
    cts = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
    gp, gx = vjp(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(out), [jnp.asarray(c) for c in cts]))

    tl = [torch.from_numpy(np.array(a)) for a in leaves]
    for i in flt:
        tl[i].requires_grad_()
    tout = tm(jax.tree_util.tree_unflatten(treedef, tl))
    touts = jax.tree_util.tree_leaves(tout)
    assert len(touts) == len(outs)
    for k, (t, o) in enumerate(zip(touts, outs)):
        assert tuple(t.shape) == tuple(np.shape(o)), (k, t.shape, o.shape)
        _close(t.detach(), o, f"output {k}")
    names = [n for n, _ in tm.named_parameters()]
    wrt = [tl[i] for i in flt] + [p for _, p in tm.named_parameters()]
    if not wrt:
        return
    grads = torch.autograd.grad(
        [t for t in touts if t.requires_grad],
        wrt, [torch.from_numpy(c) for t, c in zip(touts, cts)
              if t.requires_grad], allow_unused=True)
    for k, (g, r) in enumerate(zip(grads[:len(flt)], gx)):
        _close(torch.zeros_like(tl[flt[k]]) if g is None else g, r,
               f"d input {k}")
    ref = tensors_from_jax(tm, _np(gp))
    assert set(ref) == set(names)
    for n, g in zip(names, grads[len(flt):]):
        _close(g, ref[n], f"d {n}")


def _criterion_parity(jc, tc, inp, tgt):
    """The loss and d(loss)/d(float inputs) of a JAX and a port criterion."""
    leaves, treedef = jax.tree_util.tree_flatten(inp)
    flt = [i for i, a in enumerate(leaves) if _is_float(a)]
    jt = jax.tree_util.tree_map(jnp.asarray, tgt)

    def jfn(fl):
        ls = [jnp.asarray(a) for a in leaves]
        for i, v in zip(flt, fl):
            ls[i] = v
        return jc.forward(jax.tree_util.tree_unflatten(treedef, ls), jt)

    loss, grads = jax.value_and_grad(jfn)([jnp.asarray(leaves[i])
                                           for i in flt])
    tl = [torch.from_numpy(np.array(a)) for a in leaves]
    for i in flt:
        tl[i].requires_grad_()
    tt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                tgt)
    tloss = tc.forward(jax.tree_util.tree_unflatten(treedef, tl), tt)
    _close(tloss.detach(), loss, "loss")
    tg = torch.autograd.grad(tloss, [tl[i] for i in flt])
    for k, (g, r) in enumerate(zip(tg, grads)):
        _close(g, r, f"d input {k}")


# ------------------------------------------------------------ activation
X = _rand(1, 4, 7, scale=1.5)
POS = np.abs(X) + 0.5

ACTIVATION = [
    ("ReLU", (), X), ("ReLU6", (), X * 4), ("Threshold", (0.5, -1.0), X),
    ("PReLU", (), X), ("PReLU", (7,), X), ("RReLU", (), X),
    ("LeakyReLU", (0.1,), X), ("ELU", (), X), ("ELU", (0.5,), X),
    ("Tanh", (), X), ("TanhShrink", (), X), ("Sigmoid", (), X),
    ("LogSigmoid", (), X), ("HardTanh", (), X), ("HardTanh", (-0.5, 2.0), X),
    ("Clamp", (-2, 2), X), ("HardShrink", (0.5,), X),
    ("SoftShrink", (0.5,), X), ("SoftPlus", (), X), ("SoftPlus", (2.0,), X),
    ("SoftSign", (), X), ("SoftMax", (), X), ("SoftMax", (0,), X),
    ("SoftMin", (), X), ("LogSoftMax", (), X),
    ("Power", (2.0, 1.5, 0.5), POS), ("Power", (0.5,), POS),
    ("Square", (), X), ("Sqrt", (), POS), ("Abs", (), X), ("Exp", (), X),
    ("Log", (), POS), ("GradientReversal", (2.0,), X),
]


@pytest.mark.parametrize("cls,args,x", ACTIVATION,
                         ids=[f"{c}{a}" for c, a, _ in ACTIVATION])
def test_activation_parity(cls, args, x):
    _module_parity(getattr(jnn, cls)(*args), getattr(nn, cls)(*args), x)


def test_rrelu_training_draws_from_the_seed():
    """Stated difference: the slope is the port's hash draw, not
    threefry's. Each negative element's slope lies in [lower, upper), the
    same seed draws the same slopes, another seed others, the draws spread
    over the interval, and a seed is required in training."""
    x = torch.from_numpy(-np.abs(_rand(3, 64, 64)) - 0.1)
    m = nn.RReLU(0.1, 0.4).train()
    slope = m(x, seed=7) / x
    assert float(slope.min()) >= 0.1 and float(slope.max()) < 0.4
    assert torch.equal(m(x, seed=7), m(x, seed=7))
    assert not torch.equal(m(x, seed=7), m(x, seed=8))
    assert abs(float(slope.mean()) - 0.25) < 0.01  # U(0.1, 0.4)'s mean
    assert float(slope.std()) == pytest.approx(0.3 / 12 ** 0.5, rel=0.05)
    pos = torch.from_numpy(np.abs(_rand(4, 8, 8)))
    assert torch.equal(m(pos, seed=1), pos)
    with pytest.raises(ValueError, match="seed"):
        m(x)
    # inside a Sequential the seed reaches it folded, as jax folds the rng
    seq = nn.Sequential(nn.Identity(), nn.RReLU(0.1, 0.4)).train()
    assert core.takes_seed(seq)
    assert torch.equal(seq(x, seed=5),
                       m(x, seed=core.fold_seed(torch.tensor(5), 1)))
    assert not core.takes_seed(nn.Sequential(nn.Identity(), nn.Tanh()))


# ----------------------------------------------------------------- linear
def _pair(seed, *shape):
    return (_rand(seed, *shape), _rand(seed + 1, *shape))


LINEAR = [
    ("Bilinear", (5, 4, 3), (_rand(2, 6, 5), _rand(4, 6, 4))),
    ("Bilinear", (5, 4, 3, False), (_rand(2, 6, 5), _rand(4, 6, 4))),
    ("CMul", ((1, 1, 3),), _rand(5, 2, 4, 3)),
    ("CMul", ((4, 3),), _rand(5, 2, 4, 3)),
    ("CAdd", ((1, 1, 3),), _rand(5, 2, 4, 3)),
    ("Mul", (), _rand(6, 3, 5)), ("Add", (5,), _rand(6, 3, 5)),
    ("MulConstant", (2.5,), _rand(6, 3, 5)),
    ("AddConstant", (-1.5,), _rand(6, 3, 5)),
    ("MM", (), (_rand(7, 2, 3, 4), _rand(8, 2, 4, 5))),
    ("MM", (True, True), (_rand(7, 2, 4, 3), _rand(8, 2, 5, 4))),
    ("MV", (), (_rand(9, 2, 3, 4), _rand(10, 2, 4))),
    ("MV", (True,), (_rand(9, 2, 4, 3), _rand(10, 2, 4))),
    ("Cosine", (6, 4), _rand(11, 5, 6)),
    ("Euclidean", (6, 4), _rand(12, 5, 6)),
    ("DotProduct", (), _pair(13, 5, 6)),
    ("CosineDistance", (), _pair(14, 5, 6)),
    ("PairwiseDistance", (), _pair(15, 5, 6)),
    ("PairwiseDistance", (1,), _pair(16, 5, 6)),
    ("PairwiseDistance", (3,), _pair(17, 5, 6)),
]


@pytest.mark.parametrize("cls,args,x", LINEAR,
                         ids=[f"{c}{a}" for c, a, _ in LINEAR])
def test_linear_parity(cls, args, x):
    _module_parity(getattr(jnn, cls)(*args), getattr(nn, cls)(*args), x)


# ------------------------------------------------------------- structural
def _both(build):
    """(JAX module, port module) from one builder over a namespace."""
    return build(jnn), build(nn)


T3 = tuple(_rand(20 + i, 2, 4) for i in range(3))
IMG = _rand(30, 2, 5, 4, 3)
STRUCTURAL = [
    ("Concat", lambda n: n.Concat(n.Linear(4, 3), n.Tanh(), n.Linear(4, 2)),
     _rand(31, 3, 4)),
    ("Concat_axis1", lambda n: n.Concat(n.Identity(), n.Square(), axis=1),
     _rand(31, 3, 4)),
    ("ConcatTable", lambda n: n.ConcatTable(n.Linear(4, 3), n.Identity()),
     _rand(32, 3, 4)),
    ("ParallelTable", lambda n: n.ParallelTable(n.Linear(4, 3), n.Tanh(),
                                                n.Linear(4, 2)), T3),
    ("MapTable", lambda n: n.MapTable(n.Linear(4, 3)), T3),
    ("NarrowTable", lambda n: n.NarrowTable(1, 2), T3),
    ("FlattenTable", lambda n: n.FlattenTable(),
     (T3[0], (T3[1], (T3[2],)))),
    ("JoinTable", lambda n: n.JoinTable(), T3),
    ("JoinTable_axis0", lambda n: n.JoinTable(0), T3),
    ("MixtureTable", lambda n: n.MixtureTable(), (_rand(33, 2, 3), T3)),
    ("MixtureTable_stacked", lambda n: n.MixtureTable(),
     (_rand(33, 2, 3), _rand(34, 2, 3, 4, 5))),
    ("CriterionTable", lambda n: n.CriterionTable(n.MSECriterion()),
     (T3[0], T3[1])),
    ("Bottle", lambda n: n.Bottle(n.Linear(4, 3)), _rand(35, 2, 3, 4)),
    ("Bottle_3d", lambda n: n.Bottle(n.Linear(3, 2), 3),
     _rand(36, 2, 2, 4, 3)),
    ("Reshape", lambda n: n.Reshape([4, 5]), _rand(37, 3, 20)),
    ("View", lambda n: n.View([20]), _rand(38, 3, 4, 5)),
    ("Transpose", lambda n: n.Transpose((1, 2), (0, 3)), IMG),
    ("Squeeze", lambda n: n.Squeeze(), _rand(39, 3, 1, 4, 1)),
    ("Squeeze_axis", lambda n: n.Squeeze(1), _rand(39, 3, 1, 4, 1)),
    ("Unsqueeze", lambda n: n.Unsqueeze(-1), _rand(40, 3, 4)),
    ("Select", lambda n: n.Select(2, 1), IMG),
    ("Select_neg", lambda n: n.Select(-1, -1), IMG),
    ("SelectTable", lambda n: n.SelectTable(-1), T3),
    ("Narrow", lambda n: n.Narrow(1, 1, 3), IMG),
    ("Narrow_neg_axis", lambda n: n.Narrow(-1, 1, 2), IMG),
    ("Index", lambda n: n.Index(0), (_rand(41, 5, 4),
                                     np.array([4, 0, 2, 2], np.int32))),
    ("Index_axis1", lambda n: n.Index(1), (_rand(41, 5, 4),
                                           np.array([[3, 0], [1, 1]],
                                                    np.int32))),
    ("MaskedSelect", lambda n: n.MaskedSelect(),
     (_rand(42, 4, 5), _rand(43, 4, 5) > 0)),
    ("MaskedFill", lambda n: n.MaskedFill(-2.0),
     (_rand(42, 4, 5), _rand(43, 4, 5) > 0)),
    ("Replicate", lambda n: n.Replicate(3), _rand(44, 2, 4)),
    ("Replicate_axis", lambda n: n.Replicate(3, 2), _rand(44, 2, 4)),
    ("Padding", lambda n: n.Padding(1, -2, 1.5), _rand(45, 2, 3, 4)),
    ("SpatialZeroPadding", lambda n: n.SpatialZeroPadding(1, 2, 0, 3), IMG),
    ("Copy", lambda n: n.Copy(), _rand(46, 3, 4)),
    ("Contiguous", lambda n: n.Contiguous(), _rand(46, 3, 4)),
    ("Echo", lambda n: n.Echo(), _rand(47, 3, 4)),
    ("Max", lambda n: n.Max(), _rand(48, 3, 4, 5)),
    ("Min", lambda n: n.Min(2, True), _rand(48, 3, 4, 5)),
    ("Mean", lambda n: n.Mean(-1), _rand(48, 3, 4, 5)),
    ("Sum", lambda n: n.Sum(0, True), _rand(48, 3, 4, 5)),
    ("CAddTable", lambda n: n.CAddTable(), T3),
    ("CSubTable", lambda n: n.CSubTable(), T3[:2]),
    ("CMulTable", lambda n: n.CMulTable(), T3),
    ("CDivTable", lambda n: n.CDivTable(), (T3[0], np.abs(T3[1]) + 0.5)),
    ("CMaxTable", lambda n: n.CMaxTable(), T3),
    ("CMinTable", lambda n: n.CMinTable(), T3),
    ("Sequential", lambda n: n.Sequential(n.Linear(4, 6), n.Tanh(),
                                          n.Linear(6, 2)), _rand(49, 3, 4)),
    ("Identity", lambda n: n.Identity(), _rand(49, 3, 4)),
]


@pytest.mark.parametrize("name,build,x", STRUCTURAL,
                         ids=[c for c, _, _ in STRUCTURAL])
def test_structural_parity(name, build, x):
    _module_parity(*_both(build), x)


def test_spatial_zero_padding_crops_where_a_pad_is_negative():
    """Stated difference: the JAX layer's jnp.pad raises on a negative
    pad; the port crops, as the reference does."""
    x = _rand(50, 2, 6, 5, 3)
    with pytest.raises(ValueError):
        jnn.SpatialZeroPadding(-1, 2, 1, -2).forward({}, jnp.asarray(x))
    y = nn.SpatialZeroPadding(-1, 2, 1, -2)(torch.from_numpy(x)).numpy()
    ref = np.pad(x[:, :-2, 1:], [(0, 0), (1, 0), (0, 2), (0, 0)])
    np.testing.assert_array_equal(y, ref)


def test_core_bases_and_containers():
    """Container children are "0", "1", ... after add; len and [i];
    names; Lambda; ElementwiseModule; MapTable shares one child's
    parameters; the JAX named children match the port's."""
    c = nn.ConcatTable(name="heads").add(nn.Linear(3, 2)).add(nn.Tanh())
    assert isinstance(c, core.Container) and isinstance(c, core.Module)
    assert len(c) == 2 and isinstance(c[-1], nn.Tanh) and c.name == "heads"
    assert [n for n, _ in c.named_children()] == ["0", "1"]
    assert sorted(dict(c.named_parameters())) == ["0.bias", "0.weight"]
    assert nn.Tanh().name == "Tanh" and nn.Tanh(name="t").name == "t"
    lam = nn.Lambda(lambda t: t * 3)
    assert lam.name == "<lambda>"
    assert torch.equal(lam(torch.ones(2)), torch.full((2,), 3.0))

    def double(t):
        return 2 * t
    assert nn.Lambda(double).name == "double"
    assert isinstance(nn.Tanh(), core.ElementwiseModule)
    mt = nn.MapTable(nn.Linear(4, 3))
    assert len(list(mt.parameters())) == 2
    jm = jnn.MapTable(jnn.Linear(4, 3))
    assert set(_np(jm.init(jax.random.PRNGKey(0)))) == {"0"}
    # the JAX Lambda and the port's compute the same function
    x = _rand(51, 3, 4)
    np.testing.assert_allclose(
        nn.Lambda(torch.tanh)(torch.from_numpy(x)).numpy(),
        np.asarray(jcore.Lambda(jnp.tanh).forward({}, jnp.asarray(x))),
        atol=ATOL)


# ------------------------------------------------------------- criterion
B, C = 6, 5
LOGP = np.asarray(jax.nn.log_softmax(jnp.asarray(_rand(60, B, C)), -1))
LABELS = np.random.RandomState(61).randint(0, C, B).astype(np.int32)
SIGN = np.where(_rand(62, B) > 0, 1.0, -1.0).astype(np.float32)
PROB = (1 / (1 + np.exp(-_rand(63, B, C)))).astype(np.float32)
BITS = (_rand(64, B, C) > 0).astype(np.float32)
W = np.abs(_rand(65, C)) + 0.5
DIST = np.array(jax.nn.softmax(jnp.asarray(_rand(66, B, C) * 2), -1))
DIST[0, 1] = 0.0
MLM_TGT = np.array([[2, -1, 0, -1, -1], [4, 1, 3, 0, -1],
                    [-1, -1, -1, -1, -1], [1, -1, -1, 3, -1],
                    [0, 1, 2, 3, 4], [3, 3, -1, 1, -1]], np.int32)


CRITERION = [
    ("ClassNLLCriterion", (), {}, LOGP, LABELS),
    ("ClassNLLCriterion_w", (), {"weights": W}, LOGP, LABELS),
    ("LabelSmoothingNLLCriterion", (0.2,), {}, LOGP, LABELS),
    ("LabelSmoothingNLLCriterion_sum", (0.1, False), {}, LOGP, LABELS),
    ("MSECriterion", (), {}, _rand(67, B, C), _rand(68, B, C)),
    ("MSECriterion_sum", (False,), {}, _rand(67, B, C, scale=0.2),
     _rand(68, B, C, scale=0.2)),
    ("AbsCriterion", (), {}, _rand(67, B, C), _rand(68, B, C)),
    ("BCECriterion", (), {}, PROB, BITS),
    ("BCECriterion_w", (), {"weights": W}, PROB, PROB[::-1].copy()),
    ("CrossEntropyCriterion", (), {}, _rand(69, B, C), LABELS),
    ("CrossEntropyCriterion_w", (), {"weights": W, "size_average": False},
     _rand(69, B, C), LABELS),
    ("ClassSimplexCriterion", (C,), {}, _rand(70, B, C), LABELS),
    ("DistKLDivCriterion", (), {}, LOGP, DIST),
    ("DistKLDivCriterion_sum", (False,), {}, LOGP, DIST),
    ("CosineEmbeddingCriterion", (0.1,), {}, _pair(71, B, C), SIGN),
    ("HingeEmbeddingCriterion", (0.5,), {}, _rand(72, B), SIGN),
    ("L1HingeEmbeddingCriterion", (2.0,), {}, _pair(73, B, C), SIGN),
    ("MarginCriterion", (), {}, _rand(74, B), SIGN),
    ("MarginRankingCriterion", (0.5,), {}, _pair(75, B), SIGN),
    ("MultiLabelMarginCriterion", (), {}, _rand(76, B, C), MLM_TGT),
    ("MultiLabelSoftMarginCriterion", (), {}, _rand(77, B, C), BITS),
    ("MultiLabelSoftMarginCriterion_w", (), {"weights": W},
     _rand(77, B, C), BITS),
    ("MultiMarginCriterion", (), {}, _rand(78, B, C), LABELS),
    ("MultiMarginCriterion_p2w", (2, W, 0.5), {}, _rand(78, B, C), LABELS),
    ("SmoothL1Criterion", (), {}, _rand(79, B, C, scale=2),
     _rand(80, B, C)),
    ("SoftMarginCriterion", (), {}, _rand(81, B), SIGN),
    ("L1Cost", (), {}, _rand(82, B, C), None),
    ("L1Penalty", (0.3,), {}, _rand(83, B, C), None),
]


def _criterion(n, kind, args, kw, jax_side):
    kind = kind.split("_")[0]
    conv = jnp.asarray if jax_side else torch.from_numpy
    args = tuple(conv(a) if isinstance(a, np.ndarray) else a for a in args)
    kw = {k: conv(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return getattr(n, kind)(*args, **kw)


@pytest.mark.parametrize("kind,args,kw,x,t", CRITERION,
                         ids=[c[0] for c in CRITERION])
def test_criterion_parity(kind, args, kw, x, t):
    _criterion_parity(_criterion(jnn, kind, args, kw, True),
                      _criterion(nn, kind, args, kw, False), x, t)


@pytest.mark.parametrize("kind", ["MultiCriterion", "ParallelCriterion",
                                  "ParallelCriterion_repeat"])
def test_composite_criterion_parity(kind):
    pairs = []
    for n in (jnn, nn):
        if kind == "MultiCriterion":
            c = n.MultiCriterion().add(n.MSECriterion(), 0.5).add(
                n.AbsCriterion(), 2.0)
            x, t = _rand(84, B, C), _rand(85, B, C)
        else:
            c = n.ParallelCriterion(kind.endswith("repeat")).add(
                n.MSECriterion()).add(n.AbsCriterion(), 0.5)
            x = _pair(86, B, C)
            t = _rand(88, B, C) if kind.endswith("repeat") else _pair(88, B,
                                                                      C)
        pairs.append(c)
    _criterion_parity(*pairs, x, t)


def test_multilabel_margin_pads_every_minus_one():
    """Stated rule: a -1 anywhere in a target row is padding (the JAX
    criterion's), where ``F.multilabel_margin_loss`` stops at the first
    -1; rows without an inner -1 agree with it."""
    x = torch.from_numpy(_rand(76, B, C))
    t = torch.from_numpy(MLM_TGT).long()
    ours = nn.MultiLabelMarginCriterion()
    inner = t[:1]  # [2, -1, 0, -1, -1]: label 0 after a -1
    assert not torch.allclose(ours(x[:1], inner),
                              F.multilabel_margin_loss(x[:1], inner))
    plain = torch.tensor([[4, 1, 3, 0, -1]])
    assert torch.allclose(ours(x[1:2], plain),
                          F.multilabel_margin_loss(x[1:2], plain))


# --------------------------------------------------------- conv and pool
CONV = [
    ("SpatialShareConvolution", lambda n: n.SpatialShareConvolution(
        3, 4, 3, 3, pad_w=1, pad_h=1), _rand(90, 2, 6, 6, 3)),
    ("SpatialFullConvolution", lambda n: n.SpatialFullConvolution(
        3, 4, 3, 2, 2, 2, 1, 0, 1, 1), _rand(91, 2, 4, 5, 3)),
    ("SpatialFullConvolution_groups", lambda n: n.SpatialFullConvolution(
        4, 6, 3, 3, 2, 1, 1, 1, 0, 0, 2), _rand(92, 2, 4, 5, 4)),
    ("SpatialFullConvolution_nobias", lambda n: n.SpatialFullConvolution(
        3, 2, 4, 4, 2, 2, 1, 1, with_bias=False), _rand(93, 1, 3, 3, 3)),
    ("SpatialFullConvolution_bilinear", lambda n: n.SpatialFullConvolution(
        2, 2, 4, 4, 2, 2, 1, 1, init="bilinear_upsample"),
     _rand(94, 1, 3, 3, 2)),
    ("SpatialDilatedConvolution", lambda n: n.SpatialDilatedConvolution(
        3, 4, 3, 3, 1, 2, 2, 1, 2, 1), _rand(95, 2, 9, 8, 3)),
    ("SpatialConvolutionMap", lambda n: n.SpatialConvolutionMap(
        np.array([[0, 0], [1, 0], [2, 1], [0, 2], [2, 2]]), 3, 3, 1, 1, 1,
        1), _rand(96, 2, 5, 5, 3)),
    ("SpatialConvolutionMap_one_to_one", lambda n: n.SpatialConvolutionMap(
        n.SpatialConvolutionMap.one_to_one(3), 2, 2, 2, 2),
     _rand(97, 2, 6, 6, 3)),
    ("TemporalConvolution", lambda n: n.TemporalConvolution(5, 4, 3),
     _rand(98, 2, 9, 5)),
    ("TemporalConvolution_strided", lambda n: n.TemporalConvolution(
        5, 4, 3, 2, 1, False), _rand(99, 2, 9, 5)),
]


@pytest.mark.parametrize("name,build,x", CONV, ids=[c for c, _, _ in CONV])
def test_conv_parity(name, build, x):
    _module_parity(*_both(build), x)


@pytest.mark.parametrize("args", [(3,), (3, 2), (2, 3)])
def test_pool_parity(args):
    _module_parity(jnn.TemporalMaxPooling(*args),
                   nn.TemporalMaxPooling(*args), _rand(100, 2, 10, 4))


CONVERTED = [
    lambda n: n.SpatialFullConvolution(4, 6, 3, 2, 2, 1, 1, 0, 1, 0, 2),
    lambda n: n.SpatialFullConvolution(3, 5, 3, 3),
    lambda n: n.SpatialDilatedConvolution(3, 4, 3, 3, dilation_w=2),
    lambda n: n.SpatialShareConvolution(2, 4, 3, 1),
    lambda n: n.SpatialConvolutionMap(n.SpatialConvolutionMap.full(2, 3),
                                      3, 3),
    lambda n: n.TemporalConvolution(5, 4, 3),
]


@pytest.mark.parametrize("build", CONVERTED,
                         ids=["full_groups", "full", "dilated", "share",
                              "map", "temporal"])
def test_converted_layouts_round_trip(build):
    """Each JAX leaf goes into the port's layout and comes back equal."""
    jm, tm = _both(build)
    params = _np(jm.init(jax.random.PRNGKey(3)))
    load_jax(tm, params)
    for name, t in tm.state_dict().items():
        back = tm.to_jax_leaf(name, t)
        np.testing.assert_array_equal(back.numpy(), params[name])


@pytest.mark.parametrize("init", ["bilinear", "bilinear_upsample"])
def test_full_convolution_bilinear_init_is_the_jax_one(init):
    jm, tm = _both(lambda n: n.SpatialFullConvolution(3, 2, 4, 3, 2, 2,
                                                      init=init))
    params = _np(jm.init(jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(tm.to_jax_leaf("weight", tm.weight.data)
                                  .numpy(), params["weight"])
    np.testing.assert_array_equal(tm.bias.data.numpy(), params["bias"])


def test_convolution_map_masks_unconnected_gradients():
    m = nn.SpatialConvolutionMap(np.array([[0, 0], [1, 1]]), 3, 3)
    assert "mask" not in m.state_dict()
    m(torch.randn(1, 5, 5, 2)).sum().backward()
    g = m.weight.grad
    assert float(g[0, 1].abs().max()) == 0.0
    assert float(g[1, 0].abs().max()) == 0.0
    assert float(g[0, 0].abs().max()) > 0


# ------------------------------------------------------------------- norm
NORM = [
    ("SpatialCrossMapLRN", lambda n: n.SpatialCrossMapLRN(),
     _rand(110, 2, 4, 4, 8)),
    ("SpatialCrossMapLRN_even", lambda n: n.SpatialCrossMapLRN(
        4, 0.5, 0.6, 2.0), _rand(111, 2, 4, 4, 7)),
    ("SpatialSubtractiveNormalization",
     lambda n: n.SpatialSubtractiveNormalization(3), _rand(112, 2, 10, 11, 3)),
    ("SpatialSubtractiveNormalization_even",
     lambda n: n.SpatialSubtractiveNormalization(
         2, np.ones((4, 2), np.float32)), _rand(113, 2, 7, 6, 2)),
    ("SpatialDivisiveNormalization",
     lambda n: n.SpatialDivisiveNormalization(3, None, 1e-4),
     _rand(114, 2, 10, 10, 3)),
    ("SpatialContrastiveNormalization",
     lambda n: n.SpatialContrastiveNormalization(
         2, np.ones((5, 5), np.float32)), _rand(115, 2, 8, 9, 2)),
    ("Normalize", lambda n: n.Normalize(), _rand(116, 4, 6)),
    ("Normalize_p1", lambda n: n.Normalize(1.0), _rand(116, 4, 6)),
    ("Normalize_inf", lambda n: n.Normalize(float("inf")), _rand(116, 4, 6)),
]


@pytest.mark.parametrize("name,build,x", NORM, ids=[c for c, _, _ in NORM])
def test_norm_parity(name, build, x):
    _module_parity(*_both(build), x)


def test_lrn_window_at_an_even_size_is_the_jax_one():
    """At an even size the JAX window (one channel fewer before than
    after) is not ``F.local_response_norm``'s mirror image: the port
    follows JAX, which the parity case above holds, so it must differ from
    the library here."""
    x = torch.from_numpy(_rand(111, 2, 4, 4, 7))
    ours = nn.SpatialCrossMapLRN(4, 0.5, 0.6, 2.0)(x)
    lib = F.local_response_norm(x.permute(0, 3, 1, 2), 4, 0.5, 0.6,
                                2.0).permute(0, 2, 3, 1)
    assert float((ours - lib).abs().max()) > 1e-3
    odd = nn.SpatialCrossMapLRN(5, 0.5, 0.6, 2.0)(x)
    lib5 = F.local_response_norm(x.permute(0, 3, 1, 2), 5, 0.5, 0.6,
                                 2.0).permute(0, 2, 3, 1)
    np.testing.assert_allclose(odd.numpy(), lib5.numpy(), atol=ATOL)


def test_every_zoo_name_is_exported_as_in_the_jax_package():
    """``bigdl_tpu_torch.nn`` exports each name ``bigdl_tpu.nn`` exports
    from the files of the zoo and core's bases, ``unfuse_bn_for_spmd``
    too since data parallelism is ported."""
    import bigdl_tpu.nn.activation as a
    import bigdl_tpu.nn.conv as c
    import bigdl_tpu.nn.criterion as cr
    import bigdl_tpu.nn.linear as li
    import bigdl_tpu.nn.norm as no
    import bigdl_tpu.nn.pool as po
    import bigdl_tpu.nn.structural as st
    want = {"Module", "Container", "Sequential", "Identity", "Lambda"}
    for m in (a, c, cr, li, no, po, st):
        want |= set(m.__all__)
    missing = sorted(n for n in want if n not in nn.__all__)
    assert missing == []
    assert all(hasattr(nn, n) for n in nn.__all__)
