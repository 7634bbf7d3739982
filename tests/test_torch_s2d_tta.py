"""The space-to-depth stem and the time-to-accuracy harness of the port
against the JAX package: ``weight_from_conv7`` bit for bit, the stem and
an s2d ResNet-18 forward (f32, atol 1e-5), the CLI's ``--s2d``, the
synthetic image tree byte for byte, the grades, ``set_summary``'s rows
and ``run_time_to_acc`` with the JAX test's assertions and the JAX line's
keys; the perf rows ``resnet50_s2d`` and ``resnet50_bnss``."""

import json
import logging
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu.cli import perf as jperf
from bigdl_tpu.cli import resnet as jresnet_cli
from bigdl_tpu.models.resnet import SpaceToDepthStem as JStem
from bigdl_tpu.ops import conv2d as jc2d
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.cli import perf
from bigdl_tpu_torch.cli import resnet as resnet_cli
from bigdl_tpu_torch.interop import load_jax
from bigdl_tpu_torch.ops import conv2d as tc2d

ATOL = 1e-5

# the keys of bigdl_tpu.cli.perf.run_time_to_acc's line with its --obs,
# --lint, --autotune and supervisor off (the columns it prints null)
JAX_TTA_KEYS = {
    "attrib", "batch", "bn_fused", "ckpt_s", "classes", "collective_frac",
    "collective_s", "curve", "data_wait_s", "device", "device_s",
    "dispatch_s", "epochs_run", "final_top1", "grad_buckets",
    "grad_compress", "grade_lift", "grade_noise", "h2d_s", "hard_data",
    "hbm_headroom_frac", "hbm_peak_bytes", "image_size", "mem", "metric",
    "model", "reached", "setup_s", "stall_frac", "target_top1",
    "time_to_acc_s", "train_wall_s", "val_points", "weight_decay"}


@pytest.fixture(autouse=True)
def _pristine():
    tc2d.reset_conv_pass_layouts()
    jc2d.reset_conv_pass_layouts()
    yield
    tc2d.reset_conv_pass_layouts()
    jc2d.reset_conv_pass_layouts()


def test_weight_from_conv7_bit_equal_to_jax():
    w7 = np.random.RandomState(0).randn(7, 7, 3, 64).astype(np.float32)
    want = JStem.weight_from_conv7(w7)  # (4, 4, 12, 64) HWIO
    got = models.SpaceToDepthStem.weight_from_conv7(
        torch.from_numpy(w7).permute(3, 2, 0, 1))  # the port's (out, 3, 7, 7)
    assert got.shape == (64, 12, 4, 4)
    np.testing.assert_array_equal(
        models.SpaceToDepthStem.to_jax_leaf("weight", got).numpy(), want)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_stem_forward_against_jax_and_the_7x7_conv():
    """The stem with JAX's weight against the JAX stem; the stem with an
    embedded 7x7 kernel against the port's 7x7/2 pad-3 convolution."""
    jstem = JStem(64)
    params = jstem.init(jax.random.PRNGKey(0))
    x = _x((2, 32, 32, 3))
    jy, _ = jstem.apply(params, {}, jnp.asarray(x), training=True, rng=None)
    stem = models.SpaceToDepthStem(64)
    load_jax(stem, params)
    y = stem(torch.from_numpy(x))
    assert y.shape == (2, 16, 16, 64) and y.is_contiguous()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=ATOL)
    conv7 = nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False)
    with torch.no_grad():
        stem.weight.copy_(models.SpaceToDepthStem.weight_from_conv7(
            conv7.weight))
        np.testing.assert_allclose(stem(torch.from_numpy(x)).numpy(),
                                   conv7(torch.from_numpy(x)).numpy(),
                                   atol=ATOL)


def test_s2d_stem_init_matches_jax_distribution():
    stem = models.SpaceToDepthStem(64, generator=torch.Generator()
                                   .manual_seed(0))
    bound = float(np.sqrt(6.0 / (7 * 7 * 3 + 7 * 7 * 64)))
    w = stem.weight.detach()
    assert w.shape == (64, 12, 4, 4) and w.is_contiguous(
        memory_format=torch.channels_last)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > \
        0.9 * bound


def test_s2d_resnet18_forward_against_jax():
    """resnet(18, s2d_stem=True) at 224 x 224 (the 7x7 average pool wants
    the full size) in eval mode, JAX weights loaded with from_jax."""
    jm = jmodels.resnet(18, 10, s2d_stem=True)
    params = jm.init(jax.random.PRNGKey(0))
    state = jm.init_state()
    x = _x((1, 224, 224, 3), seed=2)
    jy, _ = jm.apply(params, state, jnp.asarray(x), training=False)
    tm = models.resnet(18, 10, s2d_stem=True)
    assert isinstance(tm[0], models.SpaceToDepthStem)
    load_jax(tm, params, state)
    with torch.no_grad():
        y = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)


def test_s2d_cli_refusal_is_the_jax_one():
    with pytest.raises(SystemExit) as je:
        jresnet_cli._build_model(Namespace(dataset="cifar10", s2d=True,
                                           depth=20, classNum=10))
    with pytest.raises(SystemExit) as te:
        resnet_cli.main(["train", "--s2d", "--platform", "cpu"])
    assert str(te.value) == str(je.value)
    with pytest.raises(SystemExit) as te:
        resnet_cli.main(["test", "--s2d", "--platform", "cpu", "--model",
                         "none"])
    assert str(te.value) == str(je.value)


def test_s2d_cli_trains_and_tests(tmp_path, caplog, capsys):
    """``train --dataset imagenet --s2d`` at depth 18 (two steps), which
    pins the all-NHWC layouts as the JAX CLI does, then ``test --s2d`` on
    its checkpoint printing the run's last validation lines."""
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
            "cpu", "--depth", "18", "--classNum", "5", "-b", "2", "--s2d"]
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    resnet_cli.main(["train"] + args + ["--maxEpoch", "1", "--logEvery",
                                        "1", "--checkpoint", ck,
                                        "--fusedBN", "apply"])
    assert tc2d.get_conv_pass_layouts() == dict.fromkeys(
        ("fwd", "dgrad", "wgrad"), "NHWC") and tc2d._EXPLICIT
    msgs = [r.getMessage() for r in caplog.records]
    losses = [float(m.rsplit(" ", 1)[-1]) for m in msgs
              if m.startswith("Train 2 in ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    val = [m for m in msgs if m.startswith(("top1 accuracy is ",
                                            "top5 accuracy is "))]
    capsys.readouterr()
    resnet_cli.main(["test"] + args + ["--model", ck])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == val[-2:]


@pytest.mark.parametrize("hard", [False, True])
def test_class_image_tree_byte_equal_to_jax(tmp_path, hard):
    for pkg, root in ((jperf, tmp_path / "jax"), (perf, tmp_path / "port")):
        pkg._make_class_image_tree(str(root), 3, 2, 16, seed=5, hard=hard)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


@pytest.mark.parametrize("hard,lift,noise", [
    (False, None, None), (True, None, None), (True, 4.0, None),
    (False, None, 10.0)])
def test_resolve_grade(hard, lift, noise):
    assert perf.resolve_grade(hard, lift, noise) == \
        jperf.resolve_grade(hard, lift, noise)
    assert (perf.HARD_GRADE, perf.EASY_GRADE) == (jperf.HARD_GRADE,
                                                  jperf.EASY_GRADE)


def test_summary_rows_carry_wall_clock(tmp_path):
    """set_summary rows carry wall_s, non-decreasing, in train.jsonl and
    val.jsonl (the JAX test's model and data)."""
    from bigdl_tpu_torch.core.module import Sequential
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.optim import (SGD, Optimizer, Top1Accuracy,
                                       Trigger)

    rs = np.random.RandomState(0)
    x = rs.rand(64, 8).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.int32)
    model = Sequential(nn.Linear(8, 2), nn.LogSoftMax())
    ds = BatchDataSet(x, y, 16)
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(),
                    optim_method=SGD(learning_rate=0.5),
                    end_when=Trigger.max_epoch(2), log_every=1,
                    device="cpu")
    opt.set_validation(Trigger.every_epoch(), ds, [Top1Accuracy()])
    opt.set_summary(str(tmp_path))
    opt.optimize()
    for fname, n in (("train.jsonl", 8), ("val.jsonl", 2)):
        rows = [json.loads(line) for line in open(tmp_path / fname)]
        assert len(rows) == n and all("wall_s" in r for r in rows), fname
        assert all(a["wall_s"] <= b["wall_s"]
                   for a, b in zip(rows, rows[1:])), fname
    assert set(rows[0]) == {"iteration", "epoch", "top1_accuracy", "wall_s"}


def test_time_to_acc_harness_end_to_end(capsys):
    """The JAX test's assertions (tests/test_time_to_acc.py), with the JAX
    line's keys."""
    out = perf.run_time_to_acc("resnet20_cifar", 16, 0.75, max_epochs=3,
                               image_size=32, train_per_class=40,
                               val_per_class=10, use_bf16=False,
                               device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(out) == JAX_TTA_KEYS
    assert out["metric"] == "time_to_acc"
    assert out["epochs_run"] >= 1
    assert len(out["curve"]) == out["epochs_run"]
    assert all(r["wall_s"] > 0 and 0.0 <= r["top1"] <= 1.0
               for r in out["curve"])
    assert out["final_top1"] > 0.2
    assert out["grad_compress"] == "off" and out["grad_buckets"] is None
    if out["reached"]:
        assert out["time_to_acc_s"] is not None
        assert out["time_to_acc_s"] <= out["train_wall_s"] + 1.0
        crossing = [r for r in out["curve"] if r["top1"] >= 0.75][0]
        assert abs(crossing["wall_s"] - out["time_to_acc_s"]) < 0.02


def test_resnet50_s2d_and_bnss_rows_build():
    s2d, shape = perf.build_model("resnet50_s2d")
    assert shape == (224, 224, 3)
    assert isinstance(s2d[0], models.SpaceToDepthStem)
    bnss, _ = perf.build_model("resnet50_bnss")
    samples = {m.stat_sample for m in bnss.modules()
               if isinstance(m, nn.BatchNormalization)}
    assert samples == {32}
    plain, _ = perf.build_model("resnet50")
    assert {m.stat_sample for m in plain.modules()
            if isinstance(m, nn.BatchNormalization)} == {None}
