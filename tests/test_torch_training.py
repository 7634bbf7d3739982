"""The port's LM training stack against the JAX package's, on the CPU,
from one JAX init tree (converted with params_from_jax): the LM's loss and
every parameter gradient (flash attention on both sides: interpret-mode
Pallas kernels in JAX, the kernels' plain twins here), remat, packed rows,
the criteria, SGD and Adam, the Optimizer loop, the text/data pieces,
Dropout, and the training CLI.

Tolerances: f32 throughout. Gradients and parameters atol 1e-5 plus rtol
1e-4 (sums in other orders; the largest LM gradients are O(10)); the remat
variants against the plain port at 1e-6 (the same arithmetic recomputed)."""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import BatchDataSet as JaxBatchDataSet
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.models.transformer_lm import PackedNLLCriterion as JaxPacked
from bigdl_tpu.models.transformer_lm import \
    packed_lm_targets as jax_packed_targets
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.cli import transformerlm as lm_cli
from bigdl_tpu_torch.dataset import (BatchDataSet, Dictionary, pack_sequences,
                                     tokenize)
from bigdl_tpu_torch.interop import params_from_jax
from bigdl_tpu_torch.models import (PackedNLLCriterion, TransformerLM,
                                    packed_lm_targets)
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

VOCAB, D, LAYERS, HEADS, SEQ = 61, 32, 2, 4, 32
ATOL, RTOL = 1e-5, 1e-4


def _jax_lm(**kw):
    return jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                     num_heads=HEADS, max_len=SEQ,
                                     attn_impl="flash", pos_encoding="rope",
                                     num_kv_heads=2, **kw)


def _port_lm(**kw):
    return TransformerLM(VOCAB, d_model=D, num_layers=LAYERS,
                         num_heads=HEADS, max_len=SEQ, attn_impl="flash",
                         pos_encoding="rope", num_kv_heads=2, **kw)


@pytest.fixture(scope="module")
def tree():
    params = jax.tree_util.tree_map(
        np.asarray, _jax_lm().init(jax.random.PRNGKey(0)))
    # a smaller embedding lets attention, not the token's own embedding,
    # carry the logits (and so the gradients under test)
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.1)
    return params


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(
        np.int32)


def _packed_rows(seed):
    rs = np.random.RandomState(seed)
    docs = [rs.randint(2, VOCAB, rs.randint(3, 14)).tolist()
            for _ in range(8)]
    toks, segs = pack_sequences(docs, SEQ)
    assert len(toks) >= 2 and (segs == 0).any() and (segs > 1).any()
    return toks[:2], segs[:2]


def _close(got: dict, ref: dict, atol=ATOL, rtol=RTOL):
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                   rtol=rtol, err_msg=name)


def _jax_value_and_grad(jm, params, x, loss_of):
    def loss_fn(p):
        out, _ = jm.apply(p, jm.init_state(), x, training=True,
                          rng=jax.random.PRNGKey(1))
        return loss_of(out)
    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), {k: v.numpy() for k, v in
                         params_from_jax(jax.tree_util.tree_map(
                             np.asarray, grads)).items()}


def _port_value_and_grad(pm, x, loss_of):
    pm.zero_grad(set_to_none=True)
    loss = loss_of(pm(x))
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy().copy()
                                  for k, p in pm.named_parameters()}


@pytest.fixture(scope="module")
def lm_grads(tree):
    """Loss and gradients of one batch, JAX and the port without remat."""
    x, y = _tokens((2, SEQ), 1), _tokens((2, SEQ), 2)
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
    ref = _jax_value_and_grad(_jax_lm(), tree, jnp.asarray(x),
                              lambda out: jcrit(out, jnp.asarray(y)))
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    pm = _port_lm().load_jax_params(tree).train()
    got = _port_value_and_grad(pm, torch.from_numpy(x),
                               lambda out: crit(out, torch.from_numpy(y)))
    return x, y, ref, got


def test_lm_loss_and_grads_match_jax(lm_grads):
    _, _, (loss_j, g_j), (loss_t, g_t) = lm_grads
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    _close(g_t, g_j)
    # attention carries gradient: its projections' grads are not ~0
    assert np.abs(g_t["encoder.0.mha.wq"]).max() > 1e-3


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_loss_and_grads(tree, lm_grads, remat):
    x, y, (loss_j, g_j), (loss_t, g_t) = lm_grads
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    pm = _port_lm(remat=remat).load_jax_params(tree).train()
    loss_r, g_r = _port_value_and_grad(
        pm, torch.from_numpy(x), lambda out: crit(out, torch.from_numpy(y)))
    assert abs(loss_r - loss_t) <= 1e-6
    _close(g_r, g_t, atol=1e-6, rtol=0)
    _close(g_r, g_j)


def test_remat_dots_saves_only_the_weight_products(tree):
    """"dots" keeps the mm/addmm outputs and recomputes the rest: the
    backward reruns every layer's attention forward, not its projections."""
    from bigdl_tpu_torch.ops import attention_kernel as ak
    calls = {"fwd": 0, "mm": 0}
    fwd = ak.flash_attention_reference

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    pm = _port_lm(remat="dots").load_jax_params(tree).train()
    x = torch.from_numpy(_tokens((2, SEQ), 3))
    ak.flash_attention_reference = counting_fwd
    try:
        loss = pm(x).sum()
        assert calls["fwd"] == LAYERS
        loss.backward()
    finally:
        ak.flash_attention_reference = fwd
    assert calls["fwd"] == 2 * LAYERS  # recomputed once per layer


def test_packed_rows_match_jax(tree):
    toks, segs = _packed_rows(seed=4)
    jt, jw = jax_packed_targets(jnp.asarray(toks), jnp.asarray(segs))
    tt, tw = packed_lm_targets(torch.from_numpy(toks),
                               torch.from_numpy(segs))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    ref = _jax_value_and_grad(
        _jax_lm(), tree, (jnp.asarray(toks), jnp.asarray(segs)),
        lambda out: JaxPacked()(out, (jt, jw)))
    pm = _port_lm().load_jax_params(tree).train()
    got = _port_value_and_grad(
        pm, (torch.from_numpy(toks), torch.from_numpy(segs)),
        lambda out: PackedNLLCriterion()(out, (tt, tw)))
    assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0])
    _close(got[1], ref[1])


def test_criteria_match_jax():
    rs = np.random.RandomState(0)
    logp = np.log(rs.dirichlet(np.ones(7), size=(3, 5))).astype(np.float32)
    y = rs.randint(0, 7, (3, 5)).astype(np.int32)
    w = rs.rand(7).astype(np.float32)
    jl, tl = jnp.asarray(logp), torch.from_numpy(logp)
    for jc, tc in (
            (jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()),
             nn.TimeDistributedCriterion(nn.ClassNLLCriterion())),
            (jnn.ClassNLLCriterion(size_average=False),
             nn.ClassNLLCriterion(size_average=False)),
            (jnn.ClassNLLCriterion(weights=jnp.asarray(w)),
             nn.ClassNLLCriterion(weights=torch.from_numpy(w)))):
        if isinstance(tc, nn.TimeDistributedCriterion):
            ref, got = jc(jl, jnp.asarray(y)), tc(tl, torch.from_numpy(y))
        else:
            ref = jc(jl[:, 0], jnp.asarray(y[:, 0]))
            got = tc(tl[:, 0], torch.from_numpy(y[:, 0]))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    wt = (rs.rand(3, 5) > 0.3).astype(np.float32)
    ref = JaxPacked()(jl, (jnp.asarray(y), jnp.asarray(wt)))
    got = PackedNLLCriterion()(tl, (torch.from_numpy(y),
                                    torch.from_numpy(wt)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("make", [
    lambda m: m.SGD(learning_rate=0.1, momentum=0.9),  # dampening = 0.9
    lambda m: m.SGD(learning_rate=0.1, momentum=0.9, dampening=0.0,
                    nesterov=True),
    lambda m: m.SGD(learning_rate=0.05, weight_decay=0.01),
    lambda m: m.Adam(learning_rate=0.01, weight_decay=0.001),
], ids=["sgd_momentum", "sgd_nesterov", "sgd_wd", "adam"])
def test_methods_match_jax_over_three_steps(make):
    rs = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jm, tm = make(joptim), make(toptim)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jm.init(jp), tm.init(tp)
    for step in range(3):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        jp, js = jm.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        ts = tm.update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                       tp)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)
    assert ts["step"] == 3


def test_sgd_dampening_defaults_to_momentum():
    assert SGD(momentum=0.9).dampening == 0.9
    w = {"w": torch.zeros(1)}
    s = SGD(learning_rate=1.0, momentum=0.9)
    st = s.update({"w": torch.ones(1)}, s.init(w), w)
    # v = 0.9 * 0 + (1 - 0.9) * 1: torch.optim.SGD's dampening 0 gives 1
    assert torch.allclose(w["w"], torch.tensor([-0.1]))
    assert st["step"] == 1


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_params_match_jax(tree, accum):
    """Six SGD steps over two shuffled epochs from one tree and the same
    BatchDataSet seed: the port's Optimizer ends at the JAX Optimizer's
    parameters."""
    x, y = _tokens((24, SEQ), 5), _tokens((24, SEQ), 6)
    make_sgd = lambda m: m.SGD(learning_rate=0.1, momentum=0.9)
    jopt = joptim.Optimizer(
        _jax_lm(), JaxBatchDataSet(x, y, 8, shuffle=True, seed=3),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()),
        optim_method=make_sgd(joptim), end_when=joptim.Trigger.max_iteration(6),
        accum_steps=accum)
    jopt.set_state(params=jax.tree_util.tree_map(jnp.asarray, tree))
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jopt.optimize().params))
    topt = Optimizer(
        _port_lm(), BatchDataSet(x, y, 8, shuffle=True, seed=3),
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
        optim_method=SGD(learning_rate=0.1, momentum=0.9),
        end_when=Trigger.max_iteration(6), accum_steps=accum, device="cpu")
    got = topt.set_state(params=params_from_jax(tree)).optimize().params
    _close({k: v.numpy() for k, v in got.items()},
           {k: v.numpy() for k, v in ref.items()})


def test_optimizer_clipping_and_nan_guard(tree):
    x, y = _tokens((8, SEQ), 7), _tokens((8, SEQ), 8)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())

    def run(**setup):
        opt = Optimizer(_port_lm(), BatchDataSet(x, y, 8), crit,
                        optim_method=SGD(learning_rate=1.0),
                        end_when=Trigger.max_iteration(1), device="cpu")
        opt.set_state(params=params_from_jax(tree))
        for name, args in setup.items():
            getattr(opt, name)(*args)
        before = params_from_jax(tree)
        after = opt.optimize().params
        return {k: before[k] - after[k] for k in before}

    step = run(set_gradient_clipping_by_l2_norm=(1e-3,))
    norm = math.sqrt(sum(float(d.square().sum()) for d in step.values()))
    assert norm == pytest.approx(1e-3, rel=1e-4)  # lr 1: the step is the grad
    step = run(set_constant_gradient_clipping=(-1e-4, 1e-4))
    # w - 1e-4 rounds to f32: off by at most half an ulp of |w| <= 1.5
    assert max(float(d.abs().max()) for d in step.values()) <= 1e-4 + 1.2e-7

    class Diverging(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(1))

        def forward(self, x):
            return self.w * float("nan") + x.float().sum()

    opt = Optimizer(Diverging(), BatchDataSet(x, y, 8), lambda o, t: o.sum(),
                    end_when=Trigger.max_iteration(1), device="cpu")
    with pytest.raises(FloatingPointError, match="NaN guard"):
        opt.optimize()


def test_optimizer_refuses_later_slices():
    """A strategy must be a DataParallel (one runs since data parallelism
    is ported), and not with steps_per_dispatch > 1; checkpoints, resume
    and steps_per_dispatch are in the port."""
    from bigdl_tpu_torch.parallel import DataParallel
    with pytest.raises(TypeError, match="must be a bigdl_tpu_torch.parallel"
                                        ".DataParallel, got object"):
        Optimizer(_port_lm(), None, None, device="cpu", strategy=object())
    with pytest.raises(ValueError, match="cannot be combined with a "
                                         "distributed strategy"):
        Optimizer(_port_lm(), None, None, device="cpu",
                  strategy=DataParallel(), steps_per_dispatch=2)
    assert Optimizer(_port_lm(), None, None, device="cpu",
                     strategy=DataParallel()).strategy.world == 1
    opt = Optimizer(_port_lm(), BatchDataSet(np.zeros((2, 4)),
                                             np.zeros((2, 4)), 2),
                    lambda o, t: o.sum(), device="cpu", steps_per_dispatch=2)
    assert opt.set_checkpoint(Trigger.every_epoch(), "x") is opt
    assert opt.resume("does-not-exist") is opt
    for bad in (lambda: Optimizer(_port_lm(), None, None, device="cpu",
                                  steps_per_dispatch=0),
                lambda: opt.set_checkpoint(Trigger.every_epoch(), "x",
                                           keep_last=0)):
        with pytest.raises(ValueError, match=">= 1"):
            bad()
    with pytest.raises(NotImplementedError, match="item 13"):
        opt.set_checkpoint(Trigger.every_epoch(), "gs://bucket/ckpt")


def test_text_pieces_and_batch_order_match_jax():
    text = ("The cat sat. The dog, the CAT and a bird sat down! Why? "
            "It's late; the bird sat.") * 3
    assert tokenize(text) == jtext.tokenize(text)
    toks = tokenize(text)
    for cap in (None, 4):
        d, jd = Dictionary([toks], cap), jtext.Dictionary([toks], cap)
        assert d.word2id == jd.word2id and d.ids(toks) == jd.ids(toks)
    rs = np.random.RandomState(0)
    seqs = [rs.randint(1, 50, rs.randint(1, 30)).tolist() for _ in range(40)]
    for got, ref in zip(pack_sequences(seqs, 32),
                        jtext.pack_sequences(seqs, 32)):
        assert np.array_equal(got, ref)
    x, y = np.arange(50)[:, None] * np.ones((1, 3)), np.arange(50)
    ours = BatchDataSet(x, y, 8, shuffle=True, seed=4)
    theirs = JaxBatchDataSet(x, y, 8, shuffle=True, seed=4)
    for _ in range(2):  # two epochs: the RandomState stream continues
        got = [b.target.tolist() for b in ours]
        assert got == [b.target.tolist() for b in theirs]
        assert len(got) == 6 and all(len(b) == 8 for b in got)


def test_dropout_keep_rate_scale_and_replay():
    """The mask is a hash of (seed, element) on the device: the keep rate
    and scale of the JAX package's Dropout (its bits are threefry's, so
    only the distribution is compared), the same mask for the same seed as
    an int or an int64 tensor, and independent masks for other seeds and
    for folded streams."""
    drop = nn.Dropout(0.25)
    x = torch.ones(200_000)
    y = drop(x, 0)
    kept = y != 0
    jy = np.asarray(jnn.Dropout(0.25).forward(
        {}, jnp.ones(200_000), training=True, rng=jax.random.PRNGKey(0)))
    for out in (y.numpy(), jy):
        assert abs(float((out != 0).mean()) - 0.75) < 0.005
        np.testing.assert_allclose(out[out != 0], 1 / 0.75, rtol=1e-6)
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, drop(x, torch.tensor(0)))
    other = drop(x, 1) != 0
    assert not torch.equal(kept, other)
    # two seeds' masks agree where independent masks would: 0.75^2 + 0.25^2
    assert abs(float((kept == other).float().mean()) - 0.625) < 0.005
    from bigdl_tpu_torch.nn.structural import fold_seed
    folded = [fold_seed(7, i) for i in range(3)]
    assert len({int(f) for f in folded}) == 3
    assert int(fold_seed(torch.tensor(7), 2)) == int(folded[2])
    with pytest.raises(ValueError, match="seed"):
        drop(x)
    assert drop.eval()(x) is x


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_dropout_under_remat_replays_its_masks(tree, remat):
    """Each layer's generator comes from (step seed, layer index) inside
    the checkpointed call, so the recompute draws the forward's masks and
    remat leaves the gradients as they were."""
    x = torch.from_numpy(_tokens((2, SEQ), 9))
    grads = []
    for r in (False, remat):
        pm = _port_lm(dropout=0.2, remat=r).load_jax_params(tree).train()
        pm(x, seed=123).sum().backward()
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6,
                                   rtol=0)
    pm = _port_lm(dropout=0.2).load_jax_params(tree).train()
    with pytest.raises(ValueError, match="seed"):
        pm(x)
    a, b = pm(x, seed=1), pm(x, seed=2)
    assert not torch.equal(a, b) and torch.equal(a, pm(x, seed=1))


def _corpus(path, n_sentences=120, seed=0):
    rs = np.random.RandomState(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta",
             "theta", "iota", "kappa", "lam", "mu"]
    p = 1.0 / np.arange(1, len(words) + 1)
    sents = [" ".join(rs.choice(words, rs.randint(3, 10), p=p / p.sum()))
             + " ." for _ in range(n_sentences)]
    (path / "input.txt").write_text(" ".join(sents))


@pytest.mark.parametrize("extra", [[], ["--packed", "--remat", "dots"]],
                         ids=["windows", "packed"])
def test_transformerlm_train_cli_on_cpu(tmp_path, capsys, caplog, extra):
    _corpus(tmp_path)
    with caplog.at_level(logging.INFO, logger="bigdl_tpu_torch"):
        trained = lm_cli.main(
            ["train", "-f", str(tmp_path), "--platform", "cpu", "--dModel",
             "32", "--numLayers", "2", "--numHeads", "2", "--seqLength",
             "32", "-b", "4", "--maxEpoch", "2", "--flash",
             "--learningRate", "0.01", "--logEvery", "1"] + extra)
    out = capsys.readouterr().out
    lines = [r.getMessage() for r in caplog.records]
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in lines
              if ln.startswith("Train 4 in ")]
    assert len(losses) >= 4 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert any(ln.startswith("Epoch 2 done: ") for ln in lines)
    assert any(ln.startswith("Training finished after ") for ln in lines)
    ppl = float(out.split("perplexity is ")[1].split()[0])
    assert math.isfinite(ppl) and ppl > 1
    assert isinstance(trained.module, torch.nn.Module)


def test_transformerlm_cli_refuses_what_is_not_ported(tmp_path, capsys):
    """--strategy dp is taken (one process exits naming torchrun, as the
    JAX CLI names XLA_FLAGS; the deprecated --dataParallel is a no-op
    there); tp and --elastic are refused by name, and so is a flag of a
    feature the port does not have."""
    _corpus(tmp_path)
    base = ["train", "-f", str(tmp_path), "--platform", "cpu"]
    small = ["--dModel", "16", "--numLayers", "1", "--numHeads", "2",
             "--seqLength", "16", "-b", "4", "--maxEpoch", "1"]
    for extra, msg in ((["--strategy", "dp"], "torchrun --nproc_per_node"),
                       (["--strategy", "tp"], "entry 13"),
                       (["--strategy", "dp", "--elastic", "hold"],
                        "entry 12")):
        with pytest.raises(SystemExit, match=msg):
            lm_cli.main(base + small + extra)
    assert lm_cli.main(base + small + ["--dataParallel"]).module is not None
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        lm_cli.main(base + ["--autotune"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments: --autotune" in err
    assert "ROADMAP.md" in err
    with pytest.raises(SystemExit):
        lm_cli.main(base + ["--optimMethod", "lbfgs"])
    assert "invalid choice: 'lbfgs'" in capsys.readouterr().err


def test_steps_per_dispatch_matches_k1_and_jax_boundaries(tree, caplog):
    """steps_per_dispatch=3 on the CPU (three eager steps a dispatch): the
    K=1 losses bit for bit, and the iterations that log, validate and
    checkpoint are the JAX Optimizer's with K=3 (7 batches an epoch:
    dispatches of 3, 3 and a tail of 1)."""
    x, y = _tokens((28, SEQ), 10), _tokens((28, SEQ), 11)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())

    def events(records):
        """The loop's log, validation and checkpoint lines in order, the
        times and numbers dropped."""
        out = []
        for r in records:
            m = r.getMessage()
            if m.startswith("Train "):
                out.append(m.split(" in ")[0])
            elif m.startswith("loss is "):
                out.append("validation")
            elif m.startswith("Checkpoint written at iteration"):
                out.append(" ".join(m.split()[:5]))
        return out

    def port(k, tmp):
        losses = []

        def rec(o, t):
            loss = crit(o, t)
            losses.append(float(loss.detach()))
            return loss

        opt = Optimizer(_port_lm(), BatchDataSet(x, y, 4), rec,
                        optim_method=SGD(learning_rate=0.1, momentum=0.9),
                        end_when=Trigger.max_iteration(14), log_every=2,
                        steps_per_dispatch=k, device="cpu")
        opt.set_state(params=params_from_jax(tree))
        opt.set_validation(Trigger.several_iteration(4),
                           BatchDataSet(x[:8], y[:8], 4),
                           [toptim.Loss(crit)])
        opt.set_checkpoint(Trigger.several_iteration(5), tmp)
        opt.optimize()
        return losses

    import tempfile
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() \
            as b, tempfile.TemporaryDirectory() as c:
        ref = port(1, a)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            got = port(3, b)
        ours = events(caplog.records)
        caplog.clear()
        jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
        jopt = joptim.Optimizer(
            _jax_lm(), JaxBatchDataSet(x, y, 4), jcrit,
            optim_method=joptim.SGD(learning_rate=0.1, momentum=0.9),
            end_when=joptim.Trigger.max_iteration(14), log_every=2,
            steps_per_dispatch=3)
        jopt.set_state(params=jax.tree_util.tree_map(jnp.asarray, tree))
        jopt.set_validation(joptim.Trigger.several_iteration(4),
                            JaxBatchDataSet(x[:8], y[:8], 4),
                            [joptim.Loss(jcrit)])
        jopt.set_checkpoint(joptim.Trigger.several_iteration(5), c)
        with caplog.at_level(logging.INFO):
            jopt.optimize()
        theirs = events(caplog.records)
    assert got == ref and len(got) == 14
    assert ours == theirs
    assert [e for e in ours if e.startswith("Checkpoint")] == [
        "Checkpoint written at iteration 6", "Checkpoint written at "
        "iteration 10"]
