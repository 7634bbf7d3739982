"""Checkpoints of the port against the JAX package's, on the CPU:
resuming a JAX ``Optimizer`` checkpoint, the JAX model loading a port
checkpoint's leaves, the port's own kill-and-resume, the snapshot
helpers on the same directory, the CLIs' ``test`` and ``generate``, and
the graphed ``Optimizer`` (``cuda``-marked: it needs a card).

Tolerances: the port against the JAX package at 1e-4 on losses (f32,
sums in other orders over a few layers); the port against itself bit for
bit (the same arithmetic in the same order)."""

import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import BatchDataSet as JaxBatchDataSet
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.cli import resnet as resnet_cli
from bigdl_tpu_torch.cli import transformerlm as lm_cli
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.dataset import mixup
from bigdl_tpu_torch.interop import load_jax, load_model, save_model
from bigdl_tpu_torch.interop.checkpoint import save_state
from bigdl_tpu_torch.optim import (SGD, Adam, Optimizer, Top1Accuracy,
                                   Trigger)
from bigdl_tpu_torch.utils import file as tfile

LOSS_ATOL = 1e-4
VOCAB, D, SEQ = 61, 32, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


class _Recording:
    """A criterion that records every step's loss (eager runs only)."""

    def __init__(self, crit):
        self.crit, self.losses = crit, []

    def __call__(self, out, target):
        loss = self.crit(out, target)
        self.losses.append(float(loss.detach()))
        return loss


def _jax_cifar():
    jm = jax_models.resnet_cifar(8)
    return (jm, _np_tree(jm.init(jax.random.PRNGKey(14))),
            _np_tree(jm.init_state()))


def _jax_run(jm, params, state, x, y, end, tmp, ckpt=None, k=1):
    """A JAX Optimizer run of SGD with momentum, no shuffle; its losses
    from the summary file."""
    summ = tmp / f"summary{end}_{k}"
    opt = joptim.Optimizer(jm, JaxBatchDataSet(x, y, 4),
                           jnn.ClassNLLCriterion(),
                           optim_method=joptim.SGD(0.1, momentum=0.9),
                           end_when=joptim.Trigger.max_iteration(end),
                           steps_per_dispatch=k)
    opt.set_state(params=jax.tree_util.tree_map(jnp.asarray, params),
                  mod_state=jax.tree_util.tree_map(jnp.asarray, state))
    opt.set_summary(str(summ))
    if ckpt:
        opt.set_checkpoint(joptim.Trigger.several_iteration(3), str(ckpt))
    trained = opt.optimize()
    return ([json.loads(ln)["loss"]
             for ln in (summ / "train.jsonl").read_text().splitlines()],
            trained)


def test_jax_checkpoint_resumed_by_the_port(tmp_path):
    """A JAX Optimizer checkpoint at iteration 3 (params, BN statistics,
    velocity, counters), resumed by the port to 6: its losses at steps 4-6
    track the uninterrupted JAX run's."""
    jm, params, state = _jax_cifar()
    x, y = _images(24, 13)
    ref, _ = _jax_run(jm, params, state, x, y, 6, tmp_path)
    _jax_run(jm, params, state, x, y, 3, tmp_path, ckpt=tmp_path / "ck")
    rec = _Recording(nn.ClassNLLCriterion())
    opt = Optimizer(models.resnet_cifar(8), BatchDataSet(x, y, 4), rec,
                    optim_method=SGD(0.1, momentum=0.9),
                    end_when=Trigger.max_iteration(6), device="cpu")
    opt.resume(str(tmp_path / "ck")).optimize()
    assert len(rec.losses) == 3
    np.testing.assert_allclose(rec.losses, ref[3:], rtol=0, atol=LOSS_ATOL)


def test_port_checkpoint_loads_into_the_jax_model(tmp_path):
    """A port checkpoint's leaves, unflattened with the JAX model's
    treedef, are the JAX model's trees: the JAX model gives the port's
    loss, and the optimizer state is the JAX SGD state's structure. The
    JAX package's load_pytree cannot open the blob (no pickled treedef:
    the stated difference)."""
    jm, params, state = _jax_cifar()
    x, y = _images(8, 15)
    tm = load_jax(models.resnet_cifar(8), params, state)
    opt = Optimizer(tm, BatchDataSet(x, y, 4), nn.ClassNLLCriterion(),
                    optim_method=SGD(0.1, momentum=0.9),
                    end_when=Trigger.max_iteration(2), device="cpu")
    opt.set_checkpoint(Trigger.several_iteration(2), str(tmp_path))
    opt.optimize()
    tm.eval()
    with torch.no_grad():
        port_loss = float(nn.ClassNLLCriterion()(tm(torch.from_numpy(x)),
                                                 torch.from_numpy(y)))

    def leaves(path):
        with np.load(path) as z:
            return [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]

    drv = {k: 0 for k in ("epoch", "epoch_records", "iteration",
                          "rng_splits")}
    treedef = jax.tree_util.tree_structure(
        {"driver": drv, "mod_state": state, "params": params})
    blob = jax.tree_util.tree_unflatten(treedef,
                                        leaves(tmp_path / "model.2"))
    assert int(blob["driver"]["iteration"]) == 2
    out = jm.forward(blob["params"], jnp.asarray(x), blob["mod_state"],
                     training=False)
    jax_loss = float(jnn.ClassNLLCriterion()(out, jnp.asarray(y)))
    assert jax_loss == pytest.approx(port_loss, abs=LOSS_ATOL)
    sgd_state = joptim.SGD(0.1, momentum=0.9).init(params)
    st = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(sgd_state), leaves(tmp_path / "state.2"))
    assert float(st["step"]) == 2.0
    for a, b in zip(jax.tree_util.tree_leaves(st["velocity"]),
                    jax.tree_util.tree_leaves(sgd_state["velocity"])):
        assert a.shape == b.shape and a.dtype == b.dtype
    with pytest.raises(KeyError, match="__treedef__"):
        jfile.load_pytree(str(tmp_path / "model.2"))


def _lm(dropout=0.0):
    return models.TransformerLM(VOCAB, d_model=D, num_layers=2, num_heads=2,
                                max_len=SEQ, dropout=dropout,
                                generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["resnet_sgd_shuffle", "lm_dropout_adam_k3"])
def test_port_kill_and_resume_is_bit_for_bit(tmp_path, case):
    """A run stopped at iteration ``stop`` and a second Optimizer resuming
    from its directory give the uninterrupted run's losses, bit for bit:
    the seed stream (dropout), the shuffled order past a finished epoch,
    the skipped records of the open one, the optimizer state and the BN
    statistics all continue."""
    if case == "resnet_sgd_shuffle":
        x, y = _images(24, 16)
        make = lambda: models.resnet_cifar(  # noqa: E731
            8, generator=torch.Generator().manual_seed(1))
        method = lambda: SGD(0.1, momentum=0.9)  # noqa: E731
        crit, k, stop, end, every = nn.ClassNLLCriterion(), 1, 8, 11, 2
    else:
        rs = np.random.RandomState(17)
        x = rs.randint(0, VOCAB, (24, SEQ)).astype(np.int32)
        y = rs.randint(0, VOCAB, (24, SEQ)).astype(np.int32)
        make = lambda: _lm(dropout=0.1)  # noqa: E731
        method = lambda: Adam(0.01)  # noqa: E731
        crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
        k, stop, end, every = 3, 9, 15, 3

    def run(last, ckpt=None, resume=None):
        rec = _Recording(crit)
        opt = Optimizer(make(), BatchDataSet(x, y, 4, shuffle=True, seed=5),
                        rec, optim_method=method(),
                        end_when=Trigger.max_iteration(last),
                        steps_per_dispatch=k, device="cpu")
        if ckpt:
            opt.set_checkpoint(Trigger.several_iteration(every), ckpt,
                               async_save=k > 1, keep_last=2)
        if resume:
            opt.resume(resume)
        opt.optimize()
        return rec.losses

    full = run(end)
    ck = str(tmp_path / "ck")
    head = run(stop, ckpt=ck)
    assert head == full[:stop]
    assert sorted(n for n in os.listdir(ck) if "." not in n[6:]) == [
        f"{p}.{i}" for p in ("model", "state") for i in (stop - every, stop)]
    tail = run(end, ckpt=ck, resume=ck)
    assert tail == full[stop:]


class _MixRecording:
    """A Mixup criterion that records every step's (y_b, lam, loss)."""

    def __init__(self):
        self.crit, self.mixes = mixup.MixupCriterion(nn.ClassNLLCriterion()), []

    def __call__(self, out, target):
        loss = self.crit(out, target)
        self.mixes.append((target[1].tolist(), float(target[2]),
                           float(loss.detach())))
        return loss


@pytest.mark.parametrize("stop", [8, 10], ids=["epoch_end", "mid_epoch"])
@pytest.mark.parametrize("stage", ["Mixup", "CutMix"])
def test_kill_and_resume_through_mixup_and_cutmix(tmp_path, stage, stop):
    """64 shuffled records in batches of 16 through Mixup(0.2, seed=1) or
    CutMix(1.0, seed=1), stopped after epoch 2 (iteration 8) or two
    batches into epoch 3 (iteration 10) and resumed: every later batch has
    the uninterrupted run's permuted targets y_b and mixing weight lam,
    and its losses, bit for bit. The finished epochs' draws are replayed
    by ``Mixup.skip``/``CutMix.skip`` without the data; the open epoch's
    consumed batches go through the stage."""
    rs = np.random.RandomState(3)
    x = rs.randn(64, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, 64).astype(np.int32)
    alpha = 0.2 if stage == "Mixup" else 1.0

    def run(last, ckpt=None):
        rec = _MixRecording()
        data = BatchDataSet(x, y, 16, shuffle=True) >> getattr(
            mixup, stage)(alpha, seed=1)
        model = nn.Sequential(nn.Reshape([192]), nn.Linear(
            192, 10, generator=torch.Generator().manual_seed(0)),
            nn.LogSoftMax())
        opt = Optimizer(model, data, rec, optim_method=SGD(0.1),
                        end_when=Trigger.max_iteration(last), device="cpu")
        if ckpt:
            opt.set_checkpoint(Trigger.several_iteration(2), ckpt)
            opt.resume(ckpt)
        opt.optimize()
        return rec.mixes

    full = run(16)
    ck = str(tmp_path / "ck")
    assert run(stop, ck) == full[:stop]
    assert run(16, ck) == full[stop:]


def _snapshot_dir(path):
    """Pairs at 2, 4 and 6 written by the port, model.6 torn after its
    sidecar, state.4's manifest torn, and an orphaned model.8."""
    tm = models.resnet_cifar(8)
    st = SGD(0.1, momentum=0.9).init(dict(tm.named_parameters()))
    for n in (2, 4, 6, 8):
        save_model(str(path / f"model.{n}"), tm)
        if n < 8:
            save_state(str(path / f"state.{n}"), st, tm)
    with open(path / "model.6", "r+b") as f:
        f.seek(100)
        f.write(b"torn")
    (path / "state.4.manifest.json").write_text('{"version": 1, "n_lea')
    return path


def test_snapshot_helpers_choose_as_the_jax_ones(tmp_path):
    d = _snapshot_dir(tmp_path / "a")
    names = sorted(os.listdir(d))
    for f in names:
        if f.rsplit(".", 1)[-1].isdigit():
            p = str(d / f)
            assert tfile.verify_checkpoint(p) == jfile.verify_checkpoint(p)
            assert tfile.verify_manifest(p) == jfile.verify_manifest(p)
    for fn in ("latest_valid_checkpoint_pair", "latest_checkpoint_pair"):
        assert getattr(tfile, fn)(str(d)) == getattr(jfile, fn)(str(d))
    assert tfile.latest_valid_checkpoint_pair(str(d)) == (
        str(d / "model.2"), str(d / "state.2"))
    assert tfile.latest_checkpoint(str(d)) == jfile.latest_checkpoint(str(d))
    assert sorted(tfile.orphaned_snapshots(str(d), 6)) == sorted(
        jfile.orphaned_snapshots(str(d), 6))
    for keep in (1, 2):
        ours, theirs = tmp_path / f"ours{keep}", tmp_path / f"theirs{keep}"
        shutil.copytree(d, ours)
        shutil.copytree(d, theirs)
        got = tfile.gc_checkpoints(str(ours), keep)
        ref = jfile.gc_checkpoints(str(theirs), keep)
        assert sorted(os.path.basename(p) for p in got) == sorted(
            os.path.basename(p) for p in ref)
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
        assert "model.2" in os.listdir(ours)  # the newest valid pair stays
    with pytest.raises(tfile.ChecksumError, match="checksum"):
        load_model(str(d / "model.6"), models.resnet_cifar(8))
    with pytest.raises(ValueError, match="keep_last"):
        tfile.gc_checkpoints(str(d), 0)


def test_resume_falls_back_refuses_and_guards(tmp_path, caplog):
    """Without a valid pair the newest model.<n> alone is loaded; a bad
    one raises ChecksumError; a snapshot that exists raises
    FileExistsError unless overwrite, except the orphans a resume may
    rewrite; a blob of a model of other widths is refused by shape."""
    x, y = _images(8, 18)

    def opt(end=2):
        return Optimizer(models.resnet_cifar(8), BatchDataSet(x, y, 4),
                         nn.ClassNLLCriterion(),
                         optim_method=SGD(0.1, momentum=0.9),
                         end_when=Trigger.max_iteration(end), device="cpu")

    d = tmp_path / "only_model"
    tm = models.resnet_cifar(8, generator=torch.Generator().manual_seed(3))
    save_model(str(d / "model.5"), tm)
    trained = opt(6).resume(str(d)).optimize().module  # one step from 5
    assert trained is not None
    with open(d / "model.5", "r+b") as f:
        f.seek(64)
        f.write(b"bad")
    with pytest.raises(tfile.ChecksumError, match="only snapshot"):
        opt().resume(str(d))
    d = str(tmp_path / "guard")
    opt().set_checkpoint(Trigger.several_iteration(2), d).optimize()
    with pytest.raises(FileExistsError, match="overwrite"):
        opt().set_checkpoint(Trigger.several_iteration(2), d).optimize()
    opt().set_checkpoint(Trigger.several_iteration(2), d,
                         overwrite=True).optimize()
    shutil.copy(os.path.join(d, "model.2"), os.path.join(d, "model.4"))
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch"):
        opt(4).set_checkpoint(Trigger.several_iteration(2), d).resume(
            d).optimize()  # model.4 is an orphan: rewritten
    assert any("unmatched snapshot" in r.getMessage()
               for r in caplog.records)
    with pytest.raises(ValueError, match="the model has"):
        load_model(os.path.join(d, "model.4"), models.resnet_cifar(8, 7))


def _write_cifar(folder, n, seed):
    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                              rs.randint(0, 256, (n, 3072))], axis=1)
        rec.astype(np.uint8).tofile(folder / name)


def test_resnet_cli_trains_graph_grouped_checkpoints_and_tests(tmp_path,
                                                               caplog,
                                                               capsys):
    """``train --stepsPerDispatch 3 --checkpoint`` then ``test --model``:
    the test's top-1 line is the training run's last validation line; a
    ``--model`` resume continues the iteration numbering."""
    _write_cifar(tmp_path, 16, seed=19)
    ck = str(tmp_path / "ck")
    base = ["train", "-f", str(tmp_path), "--platform", "cpu", "--depth",
            "8", "-b", "8", "--logEvery", "1", "--fusedBN", "apply",
            "--stepsPerDispatch", "3", "--checkpoint", ck]
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    resnet_cli.main(base + ["--maxEpoch", "1"])
    msgs = [r.getMessage() for r in caplog.records]
    top1 = [m for m in msgs if m.startswith("top1 accuracy is ")]
    assert sorted(os.listdir(ck))[0] == "model.10"
    resnet_cli.main(["test", "-f", str(tmp_path), "--platform", "cpu",
                     "--depth", "8", "-b", "8", "--model", ck])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == top1[-1]
    caplog.clear()
    resnet_cli.main(base + ["--maxEpoch", "2", "--model", ck])
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Resuming at epoch 2, iteration 10") for m in msgs)
    assert "model.20" in os.listdir(ck)


def test_lm_generate_from_a_jax_checkpoint(tmp_path, capsys):
    """``transformerlm generate --model`` on a checkpoint the JAX package
    wrote: at temperature 0 the port samples the JAX model's greedy
    tokens."""
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    rs = np.random.RandomState(20)
    (tmp_path / "input.txt").write_text(
        " ".join(rs.choice(words, 400)) + " .")
    from bigdl_tpu.dataset.text import Dictionary, tokenize
    d = Dictionary([tokenize((tmp_path / "input.txt").read_text())],
                   vocab_size=4000)
    jm = jax_models.transformer_lm(len(d), d_model=D, num_layers=2,
                                   num_heads=2, max_len=SEQ)
    params = jm.init(jax.random.PRNGKey(21))
    jfile.save_pytree({"params": params, "mod_state": jm.init_state()},
                      str(tmp_path / "ck" / "model.7"))
    got = lm_cli.main(["generate", "-f", str(tmp_path), "--platform", "cpu",
                       "--model", str(tmp_path / "ck"), "--dModel", str(D),
                       "--numLayers", "2", "--numHeads", "2", "--seqLength",
                       str(SEQ), "--prompt", "alpha beta", "--numTokens",
                       "6", "--temperature", "0"])
    prompt = np.asarray([d.ids(tokenize("alpha beta"))], np.int32)
    ref = jm.generate(params, prompt, 6, temperature=0.0)
    assert got == [d.id2word.get(int(i), "<unk>")
                   for i in np.asarray(ref)[0]]
    assert capsys.readouterr().out.strip().endswith(" ".join(got))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_cuda_graphed_optimizer_matches_eager(k):
    """On the card, steps_per_dispatch=k replays a CUDA graph of k steps:
    with cuDNN deterministic the losses are the eager run's bit for bit,
    and the BN kernels' launches count every replayed step."""
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    from bigdl_tpu_torch import ops
    x, y = _images(40, 22)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for kk in (1, k):
            rec = _DeviceRecorder(nn.ClassNLLCriterion(), 10)
            opt = Optimizer(models.resnet_cifar(
                8, fused_bn="apply",
                generator=torch.Generator().manual_seed(0)),
                BatchDataSet(x, y, 4), rec,
                optim_method=SGD(0.1, momentum=0.9),
                end_when=Trigger.max_iteration(10), steps_per_dispatch=kk)
            ops.reset_kernel_launches()
            opt.optimize()
            torch.cuda.synchronize()
            assert ops.kernel_launches()["bn_fwd_apply"] == 7 * 10
            runs.append(rec.losses())
        assert runs[0] == runs[1]
    finally:
        torch.backends.cudnn.deterministic = det


class _DeviceRecorder:
    """Every step's loss written on the device at a device index, so CUDA
    graph replays record theirs."""

    def __init__(self, crit, n):
        self.crit = crit
        self.buf = torch.zeros(n, device="cuda")
        self.i = torch.zeros(1, dtype=torch.int64, device="cuda")

    def __call__(self, out, target):
        loss = self.crit(out, target)
        self.buf.index_copy_(0, self.i, loss.detach().view(1))
        self.i.add_(1)
        return loss

    def losses(self):
        return self.buf[:int(self.i)].tolist()


@pytest.mark.cuda
def test_cuda_graphed_optimizer_checkpoint_and_top1(tmp_path):
    """A graphed run's checkpoint, loaded by ``cli.common.load_trained``
    into a fresh model, gives the trained model's top-1."""
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    from bigdl_tpu_torch.cli.common import load_trained
    from bigdl_tpu_torch.optim import Validator
    x, y = _images(32, 23)
    opt = Optimizer(models.resnet_cifar(8, fused_bn="apply"),
                    BatchDataSet(x, y, 4), nn.ClassNLLCriterion(),
                    optim_method=SGD(0.1, momentum=0.9),
                    end_when=Trigger.max_iteration(8), steps_per_dispatch=4)
    opt.set_checkpoint(Trigger.several_iteration(4), str(tmp_path))
    trained = opt.optimize().module
    ds = BatchDataSet(x, y, 8, drop_remainder=False)
    ref = Validator(trained, ds).test([Top1Accuracy()])
    fresh = load_trained(models.resnet_cifar(8), str(tmp_path))
    assert Validator(fresh, ds).test([Top1Accuracy()]) == ref
