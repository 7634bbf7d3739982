"""The port's ResNet slice against the JAX package's, on the CPU, from one
JAX init tree (converted with ``tensors_from_jax``): the conv, pooling,
linear and BN layers, the BN+ReLU rewrite, a bottleneck block and
``resnet_cifar(8)`` in every BN mode (forward, loss, every parameter
gradient, running statistics), the Optimizer with validation, the epoch
schedule, the validation methods, the CIFAR reader and the two CLIs.

Both sides run the same BN mode: the JAX package's fused models take its
interpret-mode Pallas kernels (or their jnp fallback, which computes the
same function), the port's the kernels' plain twins. Tolerances, f32:
layer outputs and gradients atol 1e-5 (sums in other orders); the models'
logits and loss atol 1e-4 and every parameter gradient max|d| <= 1e-4 *
max|g| (a few layers of such sums); running statistics atol 1e-6."""

import json
import os
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import BatchDataSet as JaxBatchDataSet
from bigdl_tpu.dataset.cifar import load_cifar10 as jax_load_cifar10
from bigdl_tpu.optim.schedules import EpochSchedule as JaxEpochSchedule
from bigdl_tpu.optim.schedules import Regime as JaxRegime
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.cli import perf as perf_cli
from bigdl_tpu_torch.cli import resnet as resnet_cli
from bigdl_tpu_torch.dataset import BatchDataSet, load_cifar10
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax
from bigdl_tpu_torch.optim import (SGD, EpochSchedule, Loss, Optimizer,
                                   Regime, Top1Accuracy, Top5Accuracy,
                                   Trigger, Validator)

ATOL = 1e-5
MODEL_ATOL = 1e-4
GRAD_REL = 1e-4
STAT_ATOL = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


def _grads_close(got: dict, ref: dict):
    assert set(got) == set(ref)
    for name, g in got.items():
        r = ref[name].float()
        worst = float((g.float() - r).abs().max())
        assert worst <= GRAD_REL * float(r.abs().max()) + 1e-12, (name, worst)


def _vjp_pair(jfn, jargs, tfn, targs, seed):
    """Outputs and input gradients of a JAX and a port function under the
    same random cotangent."""
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in jargs))
    ct = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    tt = [torch.from_numpy(np.array(a)).requires_grad_() for a in targs]
    tout = tfn(*tt)
    tg = torch.autograd.grad(tout, tt, torch.from_numpy(ct))
    return (np.asarray(out), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [g.numpy() for g in tg])


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("cfg", [
    # (nin, nout, kw, kh, sw, sh, pw, ph, groups, bias)
    (6, 8, 3, 2, 2, 1, 1, 0, 2, True),
    (4, 6, 1, 1, 1, 1, 0, 0, 1, False),
    (3, 5, 7, 7, 2, 2, 3, 3, 1, False),
])
def test_conv_matches_jax(cfg):
    jm = jnn.SpatialConvolution(*cfg[:9], with_bias=cfg[9])
    tm = nn.SpatialConvolution(*cfg[:9], with_bias=cfg[9])
    p = _np_tree(jm.init(jax.random.PRNGKey(1)))
    load_jax(tm, p)
    assert tm.weight.is_contiguous(memory_format=torch.channels_last)
    x = np.random.RandomState(2).randn(2, 11, 9, cfg[0]).astype(np.float32)
    names = ["weight"] + (["bias"] if cfg[9] else [])

    def jfn(a, *leaves):
        return jm.forward(dict(zip(names, leaves)), a)

    def tfn(a, *leaves):
        return torch.func.functional_call(tm, dict(zip(names, leaves)), (a,))

    leaves = [p[n] for n in names]
    tleaves = [tensors_from_jax(tm, {n: p[n]})[n].numpy() for n in names]
    jo, to, jg, tg = _vjp_pair(jfn, [x] + leaves, tfn, [x] + tleaves, seed=3)
    _close(to, jo)
    _close(tg[0], jg[0])
    for n, g_t, g_j in zip(names, tg[1:], jg[1:]):
        _close(g_t, tm.from_jax_leaf(n, torch.from_numpy(g_j)).numpy())


@pytest.mark.parametrize("kind,args", [
    ("max", (3, 3, 2, 2, 1, 1, True)),
    ("max", (2, 3, 2, 2, 0, 1, False)),
    ("avg", (3, 3, 2, 2, 1, 1, True)),
    ("avg_nopad", (3, 3, 2, 2, 1, 1, True)),
    ("avg", (1, 1, 2, 2, 0, 0, False)),
])
def test_pooling_matches_jax(kind, args):
    """Ceil mode with windows past the padded edge (10 + 2 - 3 over stride
    2 ends half a window out): -inf for the max, 0 in the sum, kh*kw or
    the real elements in the divisor."""
    kw = {"count_include_pad": False} if kind == "avg_nopad" else {}
    jcls, tcls = ((jnn.SpatialMaxPooling, nn.SpatialMaxPooling)
                  if kind == "max" else
                  (jnn.SpatialAveragePooling, nn.SpatialAveragePooling))
    jm, tm = jcls(*args, **kw), tcls(*args, **kw)
    x = np.random.RandomState(4).randn(2, 9, 10, 3).astype(np.float32)
    jo, to, jg, tg = _vjp_pair(lambda a: jm.forward({}, a), [x], tm, [x],
                               seed=5)
    assert to.shape == jo.shape
    _close(to, jo)
    _close(tg[0], jg[0])


def test_linear_matches_jax():
    jm, tm = jnn.Linear(12, 5, init="xavier"), nn.Linear(12, 5, init="xavier")
    p = _np_tree(jm.init(jax.random.PRNGKey(6)))
    load_jax(tm, p)
    assert tuple(tm.weight.shape) == (12, 5)  # (in, out), as in JAX
    x = np.random.RandomState(7).randn(3, 12).astype(np.float32)
    jo, to, jg, tg = _vjp_pair(
        lambda a, w, b: jm.forward({"weight": w, "bias": b}, a),
        [x, p["weight"], p["bias"]],
        lambda a, w, b: torch.func.functional_call(
            tm, {"weight": w, "bias": b}, (a,)),
        [x, p["weight"], p["bias"]], seed=8)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("case", ["off", "stats", "apply", "apply_relu",
                                  "stat_sample"])
def test_batch_norm_matches_jax(case):
    """Train then eval: y, dx, dγ, dβ, and the running statistics after the
    step (unbiased variance in the EMA)."""
    kw = {"stat_sample": 3} if case == "stat_sample" else {}
    jm, tm = jnn.BatchNormalization(8, **kw), nn.BatchNormalization(8, **kw)
    if case in ("stats", "apply", "apply_relu"):
        jm.fused = tm.fused = case.split("_")[0]
    jm.fuse_relu = tm.fuse_relu = case == "apply_relu"
    rs = np.random.RandomState(9)
    x = (rs.randn(5, 4, 3, 8) * 2 + 0.5).astype(np.float32)
    p = {"weight": (1 + 0.2 * rs.randn(8)).astype(np.float32),
         "bias": (0.2 * rs.randn(8)).astype(np.float32)}
    state = jm.init_state()
    load_jax(tm, p, _np_tree(state))
    _, new_state = jm.apply(p, state, jnp.asarray(x), training=True)

    def jfn(a, w, b):
        return jm.apply({"weight": w, "bias": b}, state, a, training=True)[0]

    def tfn(a, w, b):
        return torch.func.functional_call(tm, {"weight": w, "bias": b}, (a,))

    jo, to, jg, tg = _vjp_pair(jfn, [x, p["weight"], p["bias"]], tfn,
                               [x, p["weight"], p["bias"]], seed=10)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b)
    for name in ("running_mean", "running_var"):
        _close(getattr(tm, name), new_state[name], STAT_ATOL)
    y_eval, _ = jm.apply(p, new_state, jnp.asarray(x), training=False)
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x)), y_eval)


def test_batch_norm_refuses_axis_name():
    """Any mesh axis name is taken, as the JAX BN takes it (one process:
    local statistics; over the seq axis's ranks in
    tests/test_torch_sequence_parallel.py); a name that is not a string is
    refused."""
    x = torch.randn(6, 4)
    ref = nn.BatchNormalization(4)
    want = ref.train()(x).detach()
    for axis in ("data", "model", "seq", "pipe", "expert"):
        bn = nn.BatchNormalization(4, axis_name=axis)
        assert bn.axis_name == axis
        _close(bn.train()(x).detach(), want)
    with pytest.raises(TypeError, match="a mesh axis name or None"):
        nn.BatchNormalization(4, axis_name=1)


def test_absorb_bn_relu_matches_jax():
    for jmodel, tmodel, want in (
            (jax_models.resnet50(), models.resnet50(), 33),
            (jax_models.resnet_cifar(8), models.resnet_cifar(8), 4)):
        assert nn.absorb_bn_relu(tmodel) == jnn.absorb_bn_relu(jmodel) == want
        assert nn.absorb_bn_relu(tmodel) == 0  # idempotent
        fused = [m.fuse_relu for m in tmodel.modules()
                 if isinstance(m, nn.BatchNormalization)]
        jfused = [m.fuse_relu for m in jmodel.modules()
                  if isinstance(m, jnn.BatchNormalization)]
        assert fused == jfused and sum(fused) == want
    n_bn = sum(isinstance(m, nn.BatchNormalization)
               for m in models.resnet50(fused_bn="apply").modules())
    assert n_bn == 53


def test_not_ported_parts_raise():
    """The space-to-depth stem is ported: ``resnet50(s2d_stem=True)``
    builds it, and only the JAX CLI's own refusal (--s2d on cifar10)
    remains."""
    assert isinstance(models.resnet50(s2d_stem=True)[0],
                      models.SpaceToDepthStem)
    with pytest.raises(SystemExit, match="imagenet models only"):
        resnet_cli.main(["train", "--s2d", "--platform", "cpu"])


def test_imagenet_cli_trains_and_tests(tmp_path, caplog, capsys):
    """``train --dataset imagenet -f DIR`` (ResNet-18 at 224 x 224 from
    DIR/train, Top-1 and Top-5 on DIR/val, two steps) and ``test --model``,
    which prints the training run's last validation lines."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for split, n in (("train", 2), ("val", 1)):
        for cls in ("a", "b"):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.randint(0, 256, (40, 50, 3)).astype(
                    np.uint8)).save(d / f"{i}.jpg", quality=90)
    ck = str(tmp_path / "ck")
    args = ["--dataset", "imagenet", "-f", str(tmp_path), "--platform",
            "cpu", "--depth", "18", "--classNum", "5", "-b", "2"]
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    resnet_cli.main(["train"] + args + ["--maxEpoch", "1", "--logEvery",
                                        "1", "--checkpoint", ck,
                                        "--dataWorkers", "2"])
    msgs = [r.getMessage() for r in caplog.records]
    assert sum(m.startswith("Train 2 in ") for m in msgs) == 2
    val = [m for m in msgs if m.startswith(("top1 accuracy is ",
                                            "top5 accuracy is "))]
    assert len(val) == 2 and "model.2" in os.listdir(ck)
    resnet_cli.main(["test"] + args + ["--model", ck])
    assert capsys.readouterr().out.strip().splitlines()[-2:] == val


# ------------------------------------------------------------------ models
def _block_pair(fused):
    jm = jax_models.bottleneck_block(256, 128)
    tm = models.bottleneck_block(256, 128)
    if fused:
        jnn.set_bn_fused(jm, fused)
        nn.set_bn_fused(tm, fused)
    return jm, tm, (8, 8, 8, 256)


def _cifar_pair(fused):
    return (jax_models.resnet_cifar(8, fused_bn=fused),
            models.resnet_cifar(8, fused_bn=fused), (4, 32, 32, 3))


@pytest.mark.parametrize("fused", [False, "stats", "apply"])
@pytest.mark.parametrize("which", ["bottleneck", "resnet_cifar8"])
def test_model_matches_jax(which, fused):
    """bottleneck_block(256, 128) at 8 x 8 x 8 (rows 512, C 128 and 512:
    the JAX kernels engage) and resnet_cifar(8) at 4 x 32 x 32, one
    training forward and backward from the same params."""
    jm, tm, shape = (_block_pair if which == "bottleneck"
                     else _cifar_pair)(fused)
    params = _np_tree(jm.init(jax.random.PRNGKey(11)))
    state = _np_tree(jm.init_state())
    load_jax(tm, params, state)
    rs = np.random.RandomState(12)
    x = rs.randn(*shape).astype(np.float32)
    if which == "bottleneck":
        # zero weight wherever the block's output is within 1e-4 of its
        # final ReLU's kink, where an f32 difference could flip the mask
        # (one flip moves a gradient by a few percent)
        out0, _ = jm.apply(params, state, jnp.asarray(x), training=True)
        w = (rs.randn(*shape[:3], 512).astype(np.float32) / 512
             * (np.asarray(out0) > 1e-4))
        jloss = lambda out: jnp.sum(out * w)
        tloss = lambda out: (out * torch.from_numpy(w)).sum()
    else:
        y = rs.randint(0, 10, shape[0]).astype(np.int32)
        jloss = lambda out: jnn.ClassNLLCriterion()(out, jnp.asarray(y))
        tloss = lambda out: nn.ClassNLLCriterion()(out, torch.from_numpy(y))

    def loss_fn(p):
        out, st = jm.apply(p, state, jnp.asarray(x), training=True)
        return jloss(out), (out, st)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jl, (jout, jst)), jgrads = step(jax.tree_util.tree_map(jnp.asarray,
                                                            params))
    tm.train()
    tout = tm(torch.from_numpy(x))
    tl = tloss(tout)
    tl.backward()
    _close(tout.detach(), jout, MODEL_ATOL)
    _close(tl.detach(), jl, MODEL_ATOL)
    _grads_close({n: p.grad for n, p in tm.named_parameters()},
                 tensors_from_jax(tm, _np_tree(jgrads)))
    ref = tensors_from_jax(tm, params, _np_tree(jst))
    for name, buf in tm.named_buffers():
        _close(buf, ref[name], STAT_ATOL)


def test_optimizer_tracks_jax_over_three_steps(tmp_path):
    """resnet_cifar(8) with the fused BN block, SGD with nesterov momentum
    and weight decay, shuffle off: the loss of every step, then the
    parameters and running statistics, and a Top1/Top5 validation."""
    rs = np.random.RandomState(13)
    x = rs.randn(12, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 12).astype(np.int32)
    jm = jax_models.resnet_cifar(8, fused_bn="apply")
    params = _np_tree(jm.init(jax.random.PRNGKey(14)))
    state = _np_tree(jm.init_state())
    sgd = dict(learning_rate=0.1, momentum=0.9, dampening=0.0, nesterov=True,
               weight_decay=1e-4)
    jopt = joptim.Optimizer(jm, JaxBatchDataSet(x, y, 4),
                            jnn.ClassNLLCriterion(),
                            optim_method=joptim.SGD(**sgd),
                            end_when=joptim.Trigger.max_iteration(3))
    jopt.set_state(params=jax.tree_util.tree_map(jnp.asarray, params),
                   mod_state=jax.tree_util.tree_map(jnp.asarray, state))
    jopt.set_summary(str(tmp_path))
    trained = jopt.optimize()
    jlosses = [json.loads(ln)["loss"]
               for ln in (tmp_path / "train.jsonl").read_text().splitlines()]

    tm = models.resnet_cifar(8, fused_bn="apply")
    load_jax(tm, params, state)
    losses = []
    crit = nn.ClassNLLCriterion()

    def recording(out, target):
        loss = crit(out, target)
        losses.append(float(loss.detach()))
        return loss

    topt = Optimizer(tm, BatchDataSet(x, y, 4), recording,
                     optim_method=SGD(**sgd),
                     end_when=Trigger.max_iteration(3),
                     device="cpu")
    got = topt.optimize().params
    assert len(jlosses) == len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=MODEL_ATOL)
    ref = tensors_from_jax(tm, _np_tree(trained.params),
                           _np_tree(trained.mod_state))
    for name, t in got.items():
        _close(t, ref[name], MODEL_ATOL)

    methods = [Top1Accuracy(), Top5Accuracy(), Loss(crit)]
    jres = joptim.Validator(jm, JaxBatchDataSet(x, y, 5, drop_remainder=False)
                            ).test(trained.params, trained.mod_state,
                                   [joptim.Top1Accuracy(),
                                    joptim.Top5Accuracy(),
                                    joptim.Loss(jnn.ClassNLLCriterion())])
    tres = Validator(tm, BatchDataSet(x, y, 5, drop_remainder=False),
                     device="cpu").test(methods)
    assert tres[:2] == jres[:2] and tres[2].count == jres[2].count == 12
    assert tres[2].result()[0] == pytest.approx(jres[2].result()[0],
                                                abs=MODEL_ATOL)
    assert [m.name for m in methods] == ["top1 accuracy", "top5 accuracy",
                                         "loss"]


def test_epoch_schedule_matches_jax():
    regimes = [(1, 2, 0.1), (3, 4, 0.01), (5, 10 ** 9, 0.001)]
    ours = EpochSchedule([Regime(*r) for r in regimes])
    theirs = JaxEpochSchedule([JaxRegime(*r) for r in regimes])
    for epoch in range(0, 8):
        assert ours(0.5, 3, epoch) == pytest.approx(
            float(theirs(0.5, 3, epoch)), rel=1e-6)


def _write_cifar(folder, n, seed):
    rs = np.random.RandomState(seed)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                              rs.randint(0, 256, (n, 3072))], axis=1)
        rec.astype(np.uint8).tofile(folder / name)


def test_cifar_reader_matches_jax(tmp_path):
    _write_cifar(tmp_path, 7, seed=15)
    for train in (True, False):
        for got, ref in zip(load_cifar10(str(tmp_path), train),
                            jax_load_cifar10(str(tmp_path), train)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    (tmp_path / "test_batch.bin").write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="3073-byte"):
        load_cifar10(str(tmp_path), train=False)


def test_resnet_train_cli_on_cpu(tmp_path, caplog):
    _write_cifar(tmp_path, 16, seed=16)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    trained = resnet_cli.main(["train", "-f", str(tmp_path), "--platform",
                               "cpu", "--depth", "8", "-b", "8",
                               "--maxEpoch", "1", "--logEvery", "1",
                               "--fusedBN", "apply"])
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("Loss is" in m for m in msgs) == 10  # 80 records / 8
    assert any(m.startswith("top1 accuracy is AccuracyResult(") for m in msgs)
    assert nn.bn_fused_mode(trained.module) == "apply"


def test_perf_cli_resnet20_on_cpu(capsys):
    out = perf_cli.main(["-m", "resnet20_cifar", "--platform", "cpu", "-b",
                         "2", "-i", "1", "--fusedBN", "apply"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "resnet20_cifar" and line["fused_bn"] == "apply"
    assert line["dtype"] == "bfloat16" and line["tokens_per_second"] is None
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
