"""BASELINE config 4's CLIs in the port against the JAX package's, on the
CPU: ``cli.inception`` (train and test), ``cli.loadmodel`` (caffe,
torch and bigdl model types), ``cli.main``'s dispatch and refusals, and
``cli.perf``'s alexnet and inception rows and default.

Data are seeded class-banded JPEG folders written with PIL; models come
from seeded numpy trees of the JAX init's shapes (``seeded_tree`` of
``test_torch_inception.py``) and seeded caffemodels (``alexnet_caffemodel``
of ``test_torch_caffe_t7.py``). Where a number is
compared with the JAX tool's on the same weights and images, the printed
``Top1Accuracy``/``Top5Accuracy`` lines must be equal."""

import argparse
import contextlib
import io
import json
import logging
import math

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import inception as jax_inception
from bigdl_tpu.cli import loadmodel as jax_loadmodel
from bigdl_tpu.cli import main as jax_main
from bigdl_tpu.cli import perf as jax_perf
from bigdl_tpu.interop import torch_import as jax_ti
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.cli import inception as inception_cli
from bigdl_tpu_torch.cli import loadmodel as loadmodel_cli
from bigdl_tpu_torch.cli import main as cli_main
from bigdl_tpu_torch.cli import perf as perf_cli
from test_torch_caffe_t7 import alexnet_caffemodel
from test_torch_inception import seeded_tree


def write_jpeg_tree(root, splits=(("train", 2), ("val", 2)), classes=2,
                    side=40, seed=0):
    """``root/<split>/c<k>/<i>.jpg``: class k a colour band over noise."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    for split, per in splits:
        for k in range(classes):
            d = root / split / f"c{k}"
            d.mkdir(parents=True)
            for i in range(per):
                img = rs.randint(0, 60, (side, side, 3))
                img[:, :, k % 3] += 150
                Image.fromarray(img.astype(np.uint8)).save(d / f"{i}.jpg")
    return root


def _printed(run, *args):
    """The ``<method> is <result>`` lines ``run(*args)`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run(*args)
    return [ln for ln in out.getvalue().splitlines() if " is " in ln]


# ------------------------------------------------------------ inception
@pytest.mark.parametrize("name,fused", [("inception_v1", None),
                                        ("inception_v2", "apply")])
def test_inception_cli_trains_and_tests(tmp_path, caplog, name, fused):
    """2 iterations at batch 2 on ``train/``, a Top-1 and Top-5
    validation on ``val/``, a checkpoint; ``test`` on it prints the
    training run's last validation lines."""
    write_jpeg_tree(tmp_path)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    ck = tmp_path / "ck"
    argv = ["train", "-f", str(tmp_path), "--platform", "cpu", "-b", "2",
            "--maxEpoch", "1", "--logEvery", "1", "--modelName", name,
            "--classNum", "10", "--maxIteration", "4", "--learningRate",
            "0.01", "--checkpoint", str(ck)]
    trained = inception_cli.main(argv + (["--fusedBN", fused] if fused
                                         else []))
    msgs = [r.getMessage() for r in caplog.records]
    losses = [float(m.rsplit(" ", 1)[1]) for m in msgs if "Loss is" in m]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    val = [m for m in msgs if m.startswith(("top1 accuracy is ",
                                            "top5 accuracy is "))]
    assert len(val) == 2 and val[0].endswith("/4)")
    model = trained.module
    assert model.name == {"inception_v1": "Inception_v1_NoAux",
                          "inception_v2": "Inception_v2"}[name]
    assert nn.bn_fused_mode(model) == (fused or "off")
    if fused:
        assert sum(isinstance(m, nn.BatchNormalization) and m.fuse_relu
                   for m in model.modules()) == 57
    got = _printed(inception_cli.main, ["test", "-f", str(tmp_path),
                                        "--platform", "cpu", "--model",
                                        str(ck), "-b", "2", "--modelName",
                                        name, "--classNum", "10"])
    assert got == val
    (tmp_path / "val").rename(tmp_path / "held")
    with pytest.raises(FileNotFoundError, match="needs .*/val/<class>"):
        inception_cli.main(["test", "-f", str(tmp_path), "--platform",
                            "cpu", "--model", str(ck), "--modelName", name,
                            "--classNum", "10"])


def test_jax_checkpoint_through_inception_test_and_loadmodel(tmp_path):
    """A checkpoint the JAX package wrote: ``cli.inception test`` and
    ``cli.loadmodel --modelType bigdl`` print the JAX tools' lines, and
    ``cli.main`` dispatches both."""
    write_jpeg_tree(tmp_path, splits=(("val", 3),), classes=3, seed=1)
    jm = jax_models.inception_v1_no_aux(10)
    jfile.save_pytree({"params": seeded_tree(jm, 1),
                       "mod_state": jm.init_state()},
                      str(tmp_path / "jck" / "model.2"))
    args = ["-f", str(tmp_path), "--model", str(tmp_path / "jck"), "-b",
            "3", "--modelName", "inception_v1", "--classNum", "10"]
    ref = _printed(jax_inception.main, ["test"] + args)
    assert len(ref) == 2 and ref[0].endswith("/9)")
    assert _printed(cli_main.main, ["inception", "test", "--platform",
                                    "cpu"] + args) == ref
    lm_args = ["--modelType", "bigdl", "--modelName", "inception_v1",
               "--model", str(tmp_path / "jck"), "-f",
               str(tmp_path / "val"), "-b", "3", "--classNum", "10"]
    assert _printed(jax_loadmodel.main, lm_args) == ref
    assert _printed(cli_main.main, ["loadmodel", "--platform", "cpu"]
                    + lm_args) == ref


# ------------------------------------------------------------ loadmodel
def test_loadmodel_caffe_alexnet_matches_the_jax_tool(tmp_path):
    """A seeded AlexNet caffemodel at 10 classes through ``--modelType
    caffe`` (227 x 227 crops): the JAX tool's Top-1 and Top-5 lines."""
    write_jpeg_tree(tmp_path, splits=(("val", 2),), classes=3, side=64,
                    seed=2)
    weights, _ = alexnet_caffemodel(tmp_path / "a.caffemodel", classes=10)
    (tmp_path / "deploy.prototxt").write_text('name: "AlexNet"\n')
    args = ["--modelType", "caffe", "--modelName", "alexnet", "--model",
            str(tmp_path / "deploy.prototxt"), "--weights", weights, "-f",
            str(tmp_path / "val"), "-b", "3", "--classNum", "10"]
    ref = _printed(jax_loadmodel.main, args)
    assert len(ref) == 2 and ref[0].endswith("/6)")
    assert _printed(loadmodel_cli.main, args + ["--platform", "cpu"]) == ref
    with pytest.raises(SystemExit, match="--modelName is required"):
        loadmodel_cli.main([a for a in args if a != "alexnet"
                            and a != "--modelName"] + ["--platform", "cpu"])


def _small_net():
    """A net the JAX exporter takes, for 32 x 32 images."""
    return jnn.Sequential(
        jnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
        jnn.SpatialBatchNormalization(8), jnn.ReLU(),
        jnn.Concat(jnn.Sequential(jnn.SpatialConvolution(8, 4, 1, 1),
                                  jnn.ReLU()),
                   jnn.SpatialConvolution(8, 4, 3, 3, 1, 1, 1, 1), axis=-1),
        jnn.SpatialAveragePooling(8, 8, 8, 8), jnn.Reshape([128]),
        jnn.Linear(128, 10), jnn.LogSoftMax())


def test_loadmodel_torch_t7_matches_the_jax_tool(tmp_path):
    """A ``.t7`` from the JAX exporter through ``--modelType torch``
    (``--modelName`` ignored, as in the JAX tool): the JAX tool's
    lines."""
    write_jpeg_tree(tmp_path, splits=(("val", 4),), classes=3, seed=3)
    jm = _small_net()
    params = seeded_tree(jm, 3)
    path = str(tmp_path / "net.t7")
    jax_ti.save_torch_module(jm, params, jm.init_state(), path,
                             example_input=jax.ShapeDtypeStruct(
                                 (1, 32, 32, 3), np.float32))
    args = ["--modelType", "torch", "--modelName", "vgg16", "--model", path,
            "-f", str(tmp_path / "val"), "-b", "4", "--imageSize", "32"]
    ref = _printed(jax_loadmodel.main, args)
    assert len(ref) == 2 and ref[0].endswith("/12)")
    assert _printed(loadmodel_cli.main, args + ["--platform", "cpu"]) == ref


# -------------------------------------------------------------- cli.main
def test_cli_main_dispatches_and_refuses_by_name(capsys):
    assert set(cli_main._COMMANDS) == set(jax_main._COMMANDS)
    assert cli_main.main(["--help"]) == 0
    assert "loadmodel" in capsys.readouterr().out
    assert cli_main.main(["nope"]) == 2
    for cmd, module in (("lenet", "lenet"), ("inception", "inception"),
                        ("loadmodel", "loadmodel"), ("rnn", "rnn"),
                        ("autoencoder", "autoencoder"),
                        ("textclassification", "textclassification")):
        with pytest.raises(SystemExit) as e:
            cli_main.main([cmd, "--help"])
        assert e.value.code == 0
        assert f"python -m bigdl_tpu_torch.cli.{module}" in \
            capsys.readouterr().out
    later = ("explain", "lint", "predict", "batch-predict")
    assert set(cli_main._LATER) == set(later)
    for cmd in later:
        with pytest.raises(SystemExit, match=f"^{cmd}: not available in "
                                             f"the PyTorch port yet .*"
                                             f"ROADMAP.md queue 1 item"):
            cli_main.main([cmd, "x"])


# ------------------------------------------------------------------ perf
class _Parsed(Exception):
    pass


def _defaults(main, monkeypatch):
    """The namespace ``main([])``'s parser gives, without running."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["ns"] = orig(self, args, namespace)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main([])
    return seen["ns"]


def test_perf_rows_and_default_match_jax(monkeypatch, capsys):
    mine = _defaults(perf_cli.main, monkeypatch)
    theirs = _defaults(jax_perf.main, monkeypatch)
    assert mine.model == theirs.model == "inception_v1"
    assert (mine.batchSize, mine.iteration) == (theirs.batchSize,
                                                theirs.iteration)
    with torch.device("meta"):
        for name, arch, shape in (
                ("inception_v1", "Inception_v1_NoAux", (224, 224, 3)),
                ("inception_v2", "Inception_v2", (224, 224, 3)),
                ("alexnet", "AlexNet", (227, 227, 3))):
            model, in_shape = perf_cli.build_model(name)
            assert model.name == arch and in_shape == shape
            assert perf_cli.IMAGE_CONFIGS[name][2] == 1000
            assert model[-2].out_features == 1000
    out = perf_cli.main(["-m", "inception_v2", "--fusedBN", "apply",
                         "--platform", "cpu", "-b", "2", "-i", "1",
                         "--dataType", "random"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "inception_v2" and line["fused_bn"] == "apply"
    assert len(out["losses"]) == 3 and all(map(math.isfinite,
                                               out["losses"]))
