"""The rest of the port's cli/ and utils/ against the JAX package's on the
CPU: ``cli.predict`` (printed lines), ``utils.file.save_module``/
``load_module`` (a round trip; a JAX whole-model file refused by name,
then its weights loaded into the rebuilt model), ``utils.Classifier``
(tail padding, empty inputs), ``utils.summary``'s text, ``utils.
time_modules``' rows, and the shared provenance core
(``cli.provenance``) of the perf line and of the serving engine's
``/metrics`` provenance: an LM engine's and an image engine's carry
``bn_fused``, ``autotune``, ``conv_layouts`` and ``conv_geom_decisions``
with the JAX engine's values (the port's engine once stamped none of
them). JAX parameters come in through ``interop.load_jax``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.utils.file import save_module as jax_save_module
from bigdl_tpu.utils.file import save_pytree
from bigdl_tpu_torch import models
from bigdl_tpu_torch.interop import load_jax
from bigdl_tpu_torch.utils.file import (JaxModuleFileError, load_module,
                                        save_module)

CORE = ("bn_fused", "autotune", "conv_layouts", "conv_geom_decisions")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lenet(tmp_path_factory):
    """A JAX LeNet-5 (10 classes), its weights-only checkpoint and its
    whole-model file, and a folder of 7 seeded images (class subdirs)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("predict")
    jm = jax_models.lenet5(10)
    params = jm.init(jax.random.PRNGKey(0))
    state = jm.init_state()
    save_pytree({"params": params, "mod_state": state},
                str(root / "ck" / "model.1"))
    jax_save_module(jm, params, state, str(root / "jax_module.bin"))
    rs = np.random.RandomState(0)
    for i in range(7):
        d = root / "imgs" / ("a" if i < 4 else "b")
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (30, 26, 3)).astype(
            np.uint8)).save(d / f"{i}.png")
    return root, jm, params, state


def _port_lenet(jm, params, state):
    return load_jax(models.lenet5(10), params, state).eval()


def _lines(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return [ln for ln in capsys.readouterr().out.splitlines() if "\t" in ln]


def test_predict_lines_equal_jax(lenet, capsys):
    """``predict`` on a checkpoint directory (the --modelName rebuild) and
    on a JAX whole-model file (refused by name, then its weights loaded
    into the rebuild): the JAX CLI's printed lines, top 3, a tail of 3."""
    from bigdl_tpu.cli import predict as jax_predict
    from bigdl_tpu_torch.cli import main as cli_main
    root = lenet[0]
    for model in (str(root / "ck"), str(root / "jax_module.bin")):
        argv = ["--model", model, "-f", str(root / "imgs"), "-b", "4",
                "--topN", "3", "--classNum", "10", "--imageSize", "28"]
        want = _lines(jax_predict.main, argv, capsys)
        assert len(want) == 7
        got = _lines(cli_main.main, ["predict"] + argv + ["--platform",
                                                          "cpu"], capsys)
        assert got == want


def test_predict_on_save_module_file_and_flat_folder(lenet, tmp_path,
                                                     capsys):
    """A port whole-model file needs no rebuild: its lines equal the
    rebuilt model's on the same weights, over a flat folder."""
    import shutil

    from bigdl_tpu_torch.cli import predict
    root, jm, params, state = lenet
    flat = tmp_path / "flat"
    flat.mkdir()
    for d in ("a", "b"):
        for f in os.listdir(root / "imgs" / d):
            shutil.copy(root / "imgs" / d / f, flat / f"{d}{f}")
    save_module(_port_lenet(jm, params, state), str(tmp_path / "m.bin"))
    base = ["-f", str(flat), "-b", "4", "--topN", "2", "--imageSize", "28",
            "--platform", "cpu"]
    got = _lines(predict.main, ["--model", str(tmp_path / "m.bin")] + base,
                 capsys)
    want = _lines(predict.main, ["--model", str(root / "ck"),
                                 "--classNum", "10"] + base, capsys)
    assert len(got) == 7 and got == want


def test_save_module_round_trip_and_refusals(lenet, tmp_path):
    """save_module then load_module gives the same forward on the CPU with
    no weight in the pickle; the saved module keeps its tensors; a JAX
    whole-model file raises JaxModuleFileError, a weights-only file
    KeyError; the file also loads as a checkpoint into a built model."""
    from bigdl_tpu_torch.cli.common import load_trained
    from bigdl_tpu_torch.cli.perf import build_model
    m, _ = build_model("resnet20_cifar", class_num=10)
    m.eval()
    path = str(tmp_path / "r.bin")
    save_module(m, path)
    assert next(m.parameters()).device.type == "cpu"
    back = load_module(path).eval()
    assert all(t.device.type == "cpu" for t in back.state_dict().values())
    x = torch.from_numpy(np.random.RandomState(1).randn(
        3, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(back(x), m(x))
    assert os.path.getsize(path) < 2 * sum(
        t.numel() * 4 for t in m.state_dict().values())
    other = load_trained(build_model("resnet20_cifar", class_num=10)[0],
                         path).eval()
    with torch.no_grad():
        assert torch.equal(other(x), m(x))
    root = lenet[0]
    with pytest.raises(JaxModuleFileError, match="JAX package"):
        load_module(str(root / "jax_module.bin"))
    with pytest.raises(KeyError):
        load_module(str(root / "ck" / "model.1"))


def test_classifier_matches_jax(lenet):
    """Classifier scores and preds against the JAX Classifier at batch 4
    over 10 rows (a padded tail of 2), and the empty inputs."""
    from bigdl_tpu.utils import Classifier as JaxClassifier
    from bigdl_tpu_torch.utils import Classifier
    _, jm, params, state = lenet
    x = np.random.RandomState(2).randn(10, 28, 28, 1).astype(np.float32)
    jc = JaxClassifier(jm, params, state, batch_size=4)
    pc = Classifier(_port_lenet(jm, params, state), batch_size=4,
                    device="cpu")
    np.testing.assert_allclose(pc.predict_scores(x), jc.predict_scores(x),
                               atol=1e-5)
    assert pc(x).tolist() == jc(x).tolist()
    assert [p.tolist() for p in pc.predict_iter([x[:3], x[3:]])] == \
        [p.tolist() for p in jc.predict_iter([x[:3], x[3:]])]
    empty = np.zeros((0, 28, 28, 1), np.float32)
    assert pc.predict_scores(empty).shape == \
        jc.predict_scores(empty).shape == (0, 10)
    assert pc.predict_scores([]).shape == jc.predict_scores([]).shape
    assert pc.predict(empty).dtype == jc.predict(empty).dtype


def test_summary_text_equals_jax():
    """``summary`` is the JAX text line for line: LeNet-5 and a 2-layer
    TransformerLM (names, types, counts, the total line)."""
    from bigdl_tpu.utils import summary as jax_summary
    from bigdl_tpu_torch.utils import param_bytes, param_count, summary
    jm = jax_models.lenet5(10)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = models.lenet5(10)
    assert summary(pm) == summary(pm, jp) == jax_summary(jm, jp)
    assert param_count(pm) == sum(int(np.size(a)) for a in
                                  jax.tree_util.tree_leaves(jp))
    assert param_bytes(pm) == 4 * param_count(pm)
    jl = jax_models.transformer_lm(50, d_model=32, num_layers=2,
                                   num_heads=2, max_len=16)
    pl = models.TransformerLM(50, d_model=32, num_layers=2, num_heads=2,
                              max_len=16)
    assert summary(pl) == jax_summary(jl, jl.init(jax.random.PRNGKey(0)))


def test_time_modules_rows_as_jax(lenet, tmp_path):
    """time_modules' rows have the JAX rows' paths in the same order, a
    container's seconds the sum of its children's; format_times renders
    them; trace writes one Kineto file and refuses a nested session."""
    from bigdl_tpu.utils import time_modules as jax_time_modules
    from bigdl_tpu_torch.utils import format_times, time_modules, trace
    _, jm, params, state = lenet
    x = np.random.RandomState(3).randn(2, 28, 28, 1).astype(np.float32)
    want = jax_time_modules(jm, params, x, state, iters=1)
    pm = _port_lenet(jm, params, state)
    got = time_modules(pm, torch.from_numpy(x), iters=1)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert abs(got[0][1] - sum(dt for p, dt in got[1:]
                               if p.count(".") == 1)) < 1e-9
    assert format_times(got).splitlines()[0].startswith(got[0][0])
    with trace(str(tmp_path)):
        pm(torch.from_numpy(x))
        with pytest.raises(RuntimeError, match="another torch.profiler"):
            with trace(str(tmp_path / "inner")):
                pass
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_utils_exports_the_jax_names():
    import bigdl_tpu.utils as jax_utils
    import bigdl_tpu_torch.utils as utils
    from bigdl_tpu_torch.utils.summary import summary
    shared = {"Table", "T", "Classifier", "time_modules", "trace",
              "format_times", "param_count", "param_bytes", "summary",
              "latest_checkpoint", "check_gradients", "numerical_grad"}
    assert shared <= set(utils.__all__)
    assert all(hasattr(jax_utils, n) for n in shared)
    assert utils.summary is summary


@pytest.fixture
def _policy():
    """Both packages' conv policy and tuner mode restored after a test."""
    from bigdl_tpu.ops import conv2d as jc2d
    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.ops import conv2d as c2d
    yield c2d, jc2d
    c2d.reset_conv_pass_layouts()
    c2d.clear_geom_policy()
    jc2d.reset_conv_pass_layouts()
    tuning.set_mode("off")


def test_engine_provenance_carries_the_jax_core(lenet, _policy):
    """The flat provenance of an LM engine and of an image engine (fused
    BN ``apply``) holds the JAX engine's core keys with equal values,
    with the default conv policy and with a non-default one; the perf
    line's structured core equals JAX ``provenance_dict``'s."""
    from bigdl_tpu.cli.perf import build_model as jax_build
    from bigdl_tpu.cli.provenance import provenance_dict as jax_prov
    from bigdl_tpu.nn import set_bn_fused as jax_set_bn_fused
    from bigdl_tpu.serving import InferenceEngine as JaxEngine
    from bigdl_tpu_torch.cli.perf import _annotate_bn_fused, build_model
    from bigdl_tpu_torch.cli.provenance import provenance_dict
    from bigdl_tpu_torch.nn import set_bn_fused
    from bigdl_tpu_torch.serving import InferenceEngine
    c2d, jc2d = _policy
    jl = jax_models.transformer_lm(50, d_model=32, num_layers=2,
                                   num_heads=2, max_len=16)
    ji, _ = jax_build("resnet20_cifar", class_num=10)
    jax_set_bn_fused(ji, "apply")
    pi, _ = build_model("resnet20_cifar", class_num=10)
    set_bn_fused(pi, "apply")
    pairs = [(JaxEngine(jl, jl.init(jax.random.PRNGKey(0)), buckets=(1,)),
              InferenceEngine(models.TransformerLM(
                  50, d_model=32, num_layers=2, num_heads=2, max_len=16),
                  buckets=(1,), lengths=(16,), device="cpu",
                  graphs=False)),
             (JaxEngine(ji, ji.init(jax.random.PRNGKey(0)),
                        ji.init_state(), buckets=(1,)),
              InferenceEngine(pi, buckets=(1,), device="cpu",
                              graphs=False))]
    for layouts in (None, dict(fwd="NHWC", dgrad="NCHW", wgrad="NCHW")):
        if layouts is not None:
            c2d.set_conv_pass_layouts(**layouts)
            jc2d.set_conv_pass_layouts(**layouts)
        for je, pe in pairs:
            want, got = je.provenance(), pe.provenance()
            assert {k: got[k] for k in CORE} == {k: want[k] for k in CORE}
        assert provenance_dict(pi) == jax_prov(ji)
    assert pairs[1][1].provenance()["bn_fused"] == "apply"
    out = {}
    _annotate_bn_fused(out, pi)
    assert out == {"bn_fused": "apply"}
