"""BASELINE configs 1 and 2 in the port against the JAX package, on the
CPU: LeNet-5 and VGG-for-CIFAR from one JAX init tree (``load_jax``), the
MNIST reader, the LeNet and VGG CLIs, the record generator and the perf
rows.

Tolerances, f32: the models' outputs and losses atol 1e-4 and running
statistics atol 1e-5 (momentum 0.1 times the batch statistics of
activations that agree within 1e-4); LeNet's parameter gradients
max|d| <= 1e-4 * max|g|, each. VGG's whole step compares the branch
every ReLU and max pool takes in the two forwards: the gradients of each
layer past the last one whose branch differs (all of them when none
does) are held to max|d| / max|g| <= 1e-3, those before it to <= 0.2.
Its 14 ReLUs and 5 max pools follow BNs over as few as 4 rows at batch
4, whose f32 sums differ in order between the two packages: an input
within that difference of a ReLU's kink, or two within it in one
pooling window, takes the other branch, which moves one term of the
gradient sums there and below (seed 2 flips at layer 29: 27.weight
moves by 7.8e-2 * max|g| and every layer under it by 3e-3 to 5e-3; past
it all are within 4e-4). Without a flip the BNs over 4 rows set the
floor: the JAX model's own f32 gradients lie up to 1.8e-4 * max|g| from
the same step in f64 (``45.weight``, the Linear before the 1-D BN), and
the two packages up to 4e-4 apart. Each BN mode at VGG's channel counts
is held layer by layer at atol 1e-5 (the JAX side through its
interpret-mode Pallas kernels or their jnp fallback, the port through
the kernels' plain twins), and every layer by the zoo's tests. ``vgg16``
and ``vgg19`` hold their full parameter trees' names and shapes, and
their convolutional trunk's forward at a small input: their 224 x 224
forward (138M and 144M parameters) runs on the card, not here."""

import gzip
import json
import logging
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import record_gen as jax_record_gen
from bigdl_tpu.dataset import mnist as jax_mnist
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.cli import lenet as lenet_cli
from bigdl_tpu_torch.cli import perf as perf_cli
from bigdl_tpu_torch.cli import record_gen
from bigdl_tpu_torch.cli import vgg as vgg_cli
from bigdl_tpu_torch.dataset import mnist
from bigdl_tpu_torch.dataset.recordfile import list_shards
from bigdl_tpu_torch.dataset.streaming import RecordImageDataSet
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax

ATOL = 1e-5
MODEL_ATOL = 1e-4
STAT_ATOL = 1e-5
LAYER_STAT_ATOL = 1e-6
GRAD_REL = 1e-4
# VGG's whole step, max|d| / max|g| of a layer's gradients: (before the
# last ReLU or pool whose branch differs between the packages, past it)
VGG_GRAD_TOL = (2e-1, 1e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


def _grad_errors(got: dict, ref: dict) -> dict:
    """{name: max|d| / max|g|} of every parameter gradient (a gradient
    that is zero in exact arithmetic, within 1e-6, counts as 0)."""
    assert set(got) == set(ref)
    out = {}
    for name, g in got.items():
        r = ref[name].float()
        worst = float((g.float() - r).abs().max())
        out[name] = 0.0 if worst <= 1e-6 else worst / float(r.abs().max())
    return out


def _step_parity(jm, tm, x, y):
    """One training forward and backward of a JAX model and the port's,
    loaded from one init tree: log-probs, NLL loss, every parameter
    gradient and every running statistic."""
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(11)))
    state = _np_tree(jm.init_state())
    load_jax(tm, params, state)

    def loss_fn(p):
        out, st = jm.apply(p, state, jnp.asarray(x), training=True)
        return jnn.ClassNLLCriterion()(out, jnp.asarray(y)), (out, st)

    (jl, (jout, jst)), jg = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    tm.train()
    tout = tm(torch.from_numpy(x))
    tl = nn.ClassNLLCriterion()(tout, torch.from_numpy(y))
    tl.backward()
    _close(tout.detach(), jout, MODEL_ATOL)
    _close(tl.detach(), jl, MODEL_ATOL)
    ref = tensors_from_jax(tm, params, _np_tree(jst))
    for name, buf in tm.named_buffers():
        _close(buf, ref[name], STAT_ATOL)
    return _grad_errors({n: p.grad for n, p in tm.named_parameters()},
                        tensors_from_jax(tm, _np_tree(jg)))


# ------------------------------------------------------------------ LeNet
def test_lenet5_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(6, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, 6).astype(np.int32)
    tm = models.lenet5(10)
    assert [type(m).__name__ for m in tm] == [
        type(m).__name__ for m in jax_models.lenet5(10)._modules]
    assert tm.name == "LeNet5"
    errs = _step_parity(jax_models.lenet5(10), tm, x, y)
    assert max(errs.values()) <= GRAD_REL, errs


# -------------------------------------------------------------------- VGG
def _decisions(h_in, module):
    """The branch taken at each element by a ReLU (input > 0) or a 2 x 2
    max pool (which of its 4 inputs is the max), else None."""
    kind = type(module).__name__
    if kind == "ReLU":
        return h_in > 0
    if kind == "SpatialMaxPooling" and h_in.shape[1] > 1:
        n, hh, ww, c = h_in.shape
        return h_in.reshape(n, hh // 2, 2, ww // 2, 2, c).transpose(
            0, 1, 3, 5, 2, 4).reshape(n, hh // 2, ww // 2, c, 4).argmax(-1)
    return None


@pytest.mark.parametrize("seed", [2, 3])
def test_vgg_for_cifar10_matches_jax_plain_bn(seed):
    """The whole training step at batch 4. Every ReLU and max pool's
    branch is compared between the two forwards; each layer past the last
    one to differ (nearer the output) holds its gradients to
    VGG_GRAD_TOL[1], each layer before it to VGG_GRAD_TOL[0]."""
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.int32)
    jm = jax_models.vgg_for_cifar10(10, dropout=False)
    tm = models.vgg_for_cifar10(10, dropout=False)
    errs = _step_parity(jm, tm, x, y)
    assert len(errs) == 45
    # the two forwards again, layer by layer, from the loaded weights
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(11)))
    state = _np_tree(jm.init_state())
    hj, ht, flipped = jnp.asarray(x), torch.from_numpy(x), -1
    for i, (jl, tl) in enumerate(zip(jm._modules, tm)):
        dj = _decisions(np.asarray(hj), jl)
        dt = _decisions(ht.detach().numpy(), tl)
        if dj is not None and not np.array_equal(dj, dt):
            flipped = i
        hj = jl.apply(params[str(i)], state[str(i)], hj, training=True)[0]
        ht = tl(ht)
    for name, e in errs.items():
        tol = VGG_GRAD_TOL[int(name.split(".")[0]) > flipped]
        assert e <= tol, (name, e, tol, flipped)


def test_vgg_for_cifar10_with_dropout_eval_forward():
    jm = jax_models.vgg_for_cifar10(10)
    tm = models.vgg_for_cifar10(10)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3)))
    rs = np.random.RandomState(3)
    state = {k: ({n: np.abs(rs.randn(*np.shape(a))).astype(np.float32)
                  + (n == "running_var") for n, a in v.items()}
                 if isinstance(v, dict) else v)
             for k, v in _np_tree(jm.init_state()).items()}
    load_jax(tm, params, state)
    x = rs.randn(3, 32, 32, 3).astype(np.float32)
    jout = jm.apply(params, state, jnp.asarray(x), training=False)[0]
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x)), jout, MODEL_ATOL)
    # training draws its dropout mask from the seed the Optimizer hands it
    from bigdl_tpu_torch.core.module import takes_seed
    assert takes_seed(tm) and not takes_seed(models.lenet5())
    tm.train()
    with pytest.raises(ValueError, match="seed"):
        tm(torch.from_numpy(x))
    a, b = tm(torch.from_numpy(x), seed=5), tm(torch.from_numpy(x), seed=5)
    assert torch.equal(a, b)


# (rows-shaped input, C, eps): VGG's channel counts at a small batch; the
# 1-D BN after Linear(512, 512)
VGG_BNS = [((2, 4, 4), 64, 1e-3), ((2, 4, 4), 128, 1e-3),
           ((2, 2, 2), 256, 1e-3), ((2, 2, 2), 512, 1e-3),
           ((2, 1, 1), 512, 1e-3), ((8,), 512, 1e-5)]


@pytest.mark.parametrize("mode", ["stats", "apply"])
@pytest.mark.parametrize("lead,c,eps", VGG_BNS,
                         ids=[f"{'x'.join(map(str, s))}x{c}"
                              for s, c, _ in VGG_BNS])
def test_vgg_bn_kernel_modes_layer_by_layer(mode, lead, c, eps):
    """Each VGG BN in each kernel mode, with its absorbed ReLU in
    ``apply``: y, dx, dγ, dβ and the running statistics."""
    jm = jnn.BatchNormalization(c, eps=eps)
    tm = nn.BatchNormalization(c, eps=eps)
    jm.fused = tm.fused = mode
    jm.fuse_relu = tm.fuse_relu = mode == "apply"
    rs = np.random.RandomState(c + len(lead))
    x = (rs.randn(*lead, c) * 1.5 + 0.3).astype(np.float32)
    p = {"weight": (1 + 0.2 * rs.randn(c)).astype(np.float32),
         "bias": (0.2 * rs.randn(c)).astype(np.float32)}
    state = jm.init_state()
    load_jax(tm, p, _np_tree(state))

    def jfn(a, w, b):
        return jm.apply({"weight": w, "bias": b}, state, a,
                        training=True)[0]

    out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(p["weight"]),
                       jnp.asarray(p["bias"]))
    ct = rs.randn(*out.shape).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    tt = [torch.from_numpy(a).requires_grad_() for a in
          (x, p["weight"], p["bias"])]
    tm.train()
    tout = torch.func.functional_call(tm, {"weight": tt[1], "bias": tt[2]},
                                      (tt[0],))
    tg = torch.autograd.grad(tout, tt, torch.from_numpy(ct))
    _close(tout.detach(), out, ATOL)
    for a, b in zip(tg, jg):
        _close(a, b, ATOL)
    _, new_state = jm.apply(p, state, jnp.asarray(x), training=True)
    for name in ("running_mean", "running_var"):
        _close(getattr(tm, name), new_state[name], LAYER_STAT_ATOL)


def test_vgg_apply_absorbs_all_fourteen_relus():
    tm = models.vgg_for_cifar10(10)
    nn.set_bn_fused(tm, "apply")
    bns = [m for m in tm.modules() if isinstance(m, nn.BatchNormalization)]
    assert len(bns) == 14 and all(b.fuse_relu for b in bns)
    jm = jax_models.vgg_for_cifar10(10)
    jnn.set_bn_fused(jm, "apply")
    assert [type(m).__name__ for m in tm] == [
        type(m).__name__ for m in jm._modules]


@pytest.mark.parametrize("name", ["vgg16", "vgg19"])
def test_vgg_imagenet_tree_and_trunk_match_jax(name):
    """The whole parameter tree (``jax.eval_shape`` of the JAX init, the
    port's model on the meta device: no weights made) in names and
    converted shapes, then the convolutional trunk (every layer before
    the Reshape) at 1 x 32 x 32 from one JAX init of those layers."""
    jm = getattr(jax_models, name)(1000)
    with torch.device("meta"):
        tm = getattr(models, name)(1000)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0))):
        key = ".".join(p.key for p in path)
        owner, _, attr = key.rpartition(".")
        convert = getattr(tm.get_submodule(owner), "from_jax_leaf",
                          lambda _, t: t)
        want[key] = tuple(convert(attr, torch.empty(leaf.shape,
                                                     device="meta")).shape)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    cut = next(i for i, m in enumerate(tm) if isinstance(m, nn.Reshape))
    jt = jnn.Sequential(*jm._modules[:cut])
    tt = nn.Sequential(*list(tm)[:cut]).to_empty(device="cpu")
    params = _np_tree(jax.jit(jt.init)(jax.random.PRNGKey(4)))
    load_jax(tt, params)
    x = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        _close(tt.eval()(torch.from_numpy(x)),
               jt.apply(params, jt.init_state(), jnp.asarray(x))[0],
               MODEL_ATOL)


# ------------------------------------------------------------------ MNIST
def _write_mnist(folder, n_train, n_test, seed=0, gz=False):
    """idx files of class-banded 28 x 28 images: label k lights rows
    2k+4..2k+6 over uniform noise."""
    rs = np.random.RandomState(seed)
    opener = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    for stem, n in (("train", n_train), ("t10k", n_test)):
        y = rs.randint(0, 10, n).astype(np.uint8)
        x = rs.randint(0, 40, (n, 28, 28))
        for i, k in enumerate(y):
            x[i, 2 * k + 4:2 * k + 7] += 200
        with opener(os.path.join(folder, f"{stem}-images-idx3-ubyte{sfx}"),
                    "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(x.astype(np.uint8).tobytes())
        with opener(os.path.join(folder, f"{stem}-labels-idx1-ubyte{sfx}"),
                    "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(y.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_matches_jax(tmp_path, gz):
    _write_mnist(str(tmp_path), 20, 7, seed=5, gz=gz)
    for train in (True, False):
        for got, ref in zip(mnist.load_mnist(str(tmp_path), train),
                            jax_mnist.load_mnist(str(tmp_path), train)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert (mnist.TRAIN_MEAN, mnist.TRAIN_STD) == (jax_mnist.TRAIN_MEAN,
                                                   jax_mnist.TRAIN_STD)
    os.remove(tmp_path / f"t10k-labels-idx1-ubyte{'.gz' if gz else ''}")
    with pytest.raises(FileNotFoundError, match="t10k"):
        mnist.load_mnist(str(tmp_path), train=False)
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack(">IIII", 7, 1, 28, 28) + bytes(784))
    with pytest.raises(ValueError, match="magic"):
        mnist.load_images(str(bad))


# ------------------------------------------------------------------- CLIs
def _lines(caplog, capsys=None):
    out = [r.getMessage() for r in caplog.records]
    if capsys is not None:
        out += capsys.readouterr().out.splitlines()
    return out


def test_lenet_cli_trains_and_tests_port_and_jax_checkpoints(
        tmp_path, caplog, capsys):
    _write_mnist(str(tmp_path), 96, 32, seed=6)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    ck = tmp_path / "ck"
    trained = lenet_cli.main(["train", "-f", str(tmp_path), "--platform",
                              "cpu", "-b", "16", "--maxEpoch", "1",
                              "--logEvery", "1", "--learningRate", "0.1",
                              "--checkpoint", str(ck)])
    msgs = _lines(caplog)
    losses = [float(m.rsplit(" ", 1)[1]) for m in msgs if "Loss is" in m]
    assert len(losses) == 6 and all(np.isfinite(losses))
    top1 = [m for m in msgs if m.startswith("top1 accuracy is ")]
    assert top1 and trained.module.name == "LeNet5"
    capsys.readouterr()
    lenet_cli.main(["test", "-f", str(tmp_path), "--platform", "cpu",
                    "--model", str(ck), "-b", "16"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == top1[-1]

    # a checkpoint the JAX package wrote: the port's Top-1 is the JAX
    # model's on the same normalised test images
    jm = jax_models.lenet5(10)
    params = jm.init(jax.random.PRNGKey(7))
    jfile.save_pytree({"params": params, "mod_state": jm.init_state()},
                      str(tmp_path / "jck" / "model.3"))
    lenet_cli.main(["test", "-f", str(tmp_path), "--platform", "cpu",
                    "--model", str(tmp_path / "jck"), "-b", "8"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    x, y = jax_mnist.load_mnist(str(tmp_path), train=False)
    xn = ((x.astype(np.float32) / 255.0) - jax_mnist.TRAIN_MEAN) \
        / jax_mnist.TRAIN_STD
    pred = np.asarray(jm.forward(params, jnp.asarray(xn))).argmax(-1)
    hits = int((pred == y).sum())
    assert got.startswith("top1 accuracy is AccuracyResult(")
    assert got.endswith(f"{hits}/{len(y)})"), (got, hits)


def _write_cifar(folder, n, seed):
    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                              rs.randint(0, 256, (n, 3072))], axis=1)
        rec.astype(np.uint8).tofile(os.path.join(folder, name))


@pytest.mark.parametrize("fused", ["off", "stats", "apply"])
def test_vgg_cli_trains_in_each_bn_mode(tmp_path, caplog, capsys, fused):
    _write_cifar(str(tmp_path), 4, seed=8)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    ck = tmp_path / "ck"
    trained = vgg_cli.main(["train", "-f", str(tmp_path), "--platform",
                            "cpu", "-b", "4", "--maxEpoch", "1",
                            "--logEvery", "1", "--fusedBN", fused,
                            "--checkpoint", str(ck)])
    msgs = _lines(caplog)
    losses = [float(m.rsplit(" ", 1)[1]) for m in msgs if "Loss is" in m]
    assert len(losses) == 5 and all(np.isfinite(losses))
    top1 = [m for m in msgs if m.startswith("top1 accuracy is ")]
    assert top1
    assert nn.bn_fused_mode(trained.module) == fused
    capsys.readouterr()
    vgg_cli.main(["test", "-f", str(tmp_path), "--platform", "cpu",
                  "--model", str(ck), "-b", "4"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == top1[-1]


def test_record_gen_writes_the_jax_tools_records(tmp_path, capsys):
    from PIL import Image

    rs = np.random.RandomState(9)
    for split, per in (("train", 5), ("val", 2)):
        for cls in ("ant", "bee"):
            d = tmp_path / "imgs" / split / cls
            d.mkdir(parents=True)
            for i in range(per):
                Image.fromarray(rs.randint(0, 256, (20 + i, 24, 3)).astype(
                    np.uint8)).save(d / f"{i}.png")
    args = ["-f", str(tmp_path / "imgs"), "-b", "3", "-p", "2"]
    written = record_gen.main(args + ["-o", str(tmp_path / "port")])
    jax_record_gen.main(args + ["-o", str(tmp_path / "jax")])
    assert [len(written[s]) for s in ("train", "val")] == [4, 2]
    for split in ("train", "val"):
        mine = list_shards(str(tmp_path / "port" / split))
        theirs = list_shards(str(tmp_path / "jax" / split))
        assert [os.path.basename(p) for p in mine] == [
            os.path.basename(p) for p in theirs]
        for a, b in zip(mine, theirs):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
    ds = RecordImageDataSet(str(tmp_path / "port" / "train"), batch_size=5,
                            crop=(16, 16), train=False, short_side=16,
                            n_threads=1)
    labels = np.concatenate([np.asarray(mb.target) for mb in ds])
    assert sorted(labels.tolist()) == [0] * 5 + [1] * 5
    shutil.rmtree(tmp_path / "imgs" / "val")
    shutil.rmtree(tmp_path / "imgs" / "train" / "bee")
    one = record_gen.main(["-f", str(tmp_path / "imgs" / "train"), "-o",
                           str(tmp_path / "one"), "--limit", "2"])
    assert list(one) == [""] and len(one[""]) == 1


def test_perf_rows_lenet5_and_vgg(capsys):
    """The JAX perf zoo's lenet5, vgg16 and vgg19 rows: input shapes and
    class counts; lenet5 trains a few bf16 steps here."""
    assert perf_cli.IMAGE_CONFIGS["lenet5"][1:] == ((28, 28, 1), 10)
    for name in ("vgg16", "vgg19"):
        assert perf_cli.IMAGE_CONFIGS[name][1:] == ((224, 224, 3), 1000)
    out = perf_cli.main(["-m", "lenet5", "--platform", "cpu", "-b", "4",
                         "-i", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "lenet5" and line["dtype"] == "bfloat16"
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
