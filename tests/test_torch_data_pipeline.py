"""The port's input pipeline against the JAX package's, on the CPU: the
native C++ pipeline (the port builds its own copy of the source), the
image transformers, the epoch plan, the executor (worker counts,
backpressure, worker errors, early exit), staging, prefetch, sharding,
Mixup/CutMix, and a JAX ``Optimizer`` checkpoint written through the
executor feed resumed by the port.

Every comparison is bit for bit (the same numpy draws, the same C
arithmetic) unless a test states a tolerance. ``--stage device`` needs a
card: its test is ``cuda``-marked and skips here."""

import logging
import threading
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import dataset as jds
from bigdl_tpu.dataset import distributed as jdist
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import mixup as jmixup
from bigdl_tpu.dataset import native as jnative
from bigdl_tpu.dataset import pipeline as jpipe
from bigdl_tpu.dataset import prefetch as jprefetch
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.dataset import dataset as tds
from bigdl_tpu_torch.dataset import distributed as tdist
from bigdl_tpu_torch.dataset import image as timage
from bigdl_tpu_torch.dataset import mixup as tmixup
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import pipeline as tpipe
from bigdl_tpu_torch.dataset import prefetch as tprefetch
from bigdl_tpu_torch.interop.checkpoint import PLAN_KEYS, load_model
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

LOSS_ATOL = 1e-4  # the port against the JAX package, f32 ResNet-8 steps

_rs = np.random.RandomState(0)
_X = _rs.randn(64, 8).astype(np.float32)
_Y = _rs.randint(0, 3, 64).astype(np.int32)


def _stream(ds, epochs=2):
    """``epochs`` epochs of (x, y) numpy pairs, with ``shuffle()`` after
    each (the Optimizer's epoch contract)."""
    out = []
    for _ in range(epochs):
        for mb in ds:
            out.append((np.array(mb.input), np.array(mb.target)))
        ds.shuffle()
    return out


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def _no_pipe_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith(("bigdl-pipe-", "bigdl-stage",
                                      "bigdl-prefetch"))]


@pytest.fixture(scope="module")
def native_libs():
    if not jnative.available():
        pytest.skip("the JAX package's native lib is unavailable")
    assert tnative.available(), tnative.load_error()
    return jnative, tnative


# ------------------------------------------------------------------ native
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("train", [True, False])
def test_native_prefetch_matches_jax(native_libs, train, threads):
    """Images and labels over two epochs, random crop 24 of 28 x 30 and
    flip when training, centre crop otherwise, per-channel normalised."""
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (40, 28, 30, 3)).astype(np.uint8)
    labels = rs.randint(0, 10, 40).astype(np.int32)
    kw = dict(batch_size=8, crop=(24, 24), train=train, seed=5,
              mean=[120.0, 110.0, 100.0], std=[60.0, 55.0, 50.0],
              n_threads=threads, queue_cap=2)
    ref = _stream(jnative.NativePrefetchDataSet(images, labels, **kw))
    got = _stream(tnative.NativePrefetchDataSet(images, labels, **kw))
    _same(ref, got)
    assert got[0][0].shape == (8, 24, 24, 3)
    if train:  # epochs differ: reshuffled, re-augmented
        assert not np.array_equal(got[0][0], got[5][0])


def test_native_resume_starts_at_the_epoch(native_libs):
    """An Optimizer resuming at epoch 3 calls skip_epoch() twice: the
    port's endless pipeline then starts at epoch 3's first batch, as an
    uninterrupted stream does."""
    rs = np.random.RandomState(2)
    images = rs.randint(0, 256, (24, 8, 8, 3)).astype(np.uint8)
    labels = np.arange(24, dtype=np.int32)
    kw = dict(batch_size=8, crop=(6, 6), train=True, seed=3)
    full = _stream(tnative.NativePrefetchDataSet(images, labels, **kw), 3)
    ds = tnative.NativePrefetchDataSet(images, labels, **kw)
    ds.skip_epoch()
    ds.skip_epoch()
    _same(full[6:], _stream(ds, 1))


def test_native_readers_and_augment_match_jax(native_libs, tmp_path):
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (30, 35, 3)).astype(np.uint8)
    mean = np.asarray([1.0, 2.0, 3.0], np.float32)
    std = np.asarray([2.0, 3.0, 4.0], np.float32)
    outs = []
    for mod in native_libs:
        out = np.empty((20, 24, 3), np.float32)
        mod.augment_sample_native(img, out, 5, 6, True, mean, std)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(
        outs[1], (img[5:25, 6:30][:, ::-1].astype(np.float32) - mean) / std)
    with pytest.raises(ValueError, match="outside source image"):
        tnative.augment_sample_native(img, np.empty((20, 24, 3), np.float32),
                                      15, 0, False, mean, std)
    rec = np.concatenate([rs.randint(0, 10, (7, 1)),
                          rs.randint(0, 256, (7, 3072))], axis=1)
    rec.astype(np.uint8).tofile(tmp_path / "b.bin")
    for a, b in zip(jnative.read_cifar10([str(tmp_path / "b.bin")]),
                    tnative.read_cifar10([str(tmp_path / "b.bin")])):
        np.testing.assert_array_equal(a, b)
    raw = bytes([0, 0, 8, 3, 0, 0, 0, 2, 0, 0, 0, 3, 0, 0, 0, 4]) + bytes(
        range(24))
    (tmp_path / "t.idx").write_bytes(raw)
    np.testing.assert_array_equal(jnative.read_idx(str(tmp_path / "t.idx")),
                                  tnative.read_idx(str(tmp_path / "t.idx")))
    assert tnative.read_idx(str(tmp_path / "t.idx")).shape == (2, 3, 4)


def test_native_library_builds_into_build_dir():
    assert tnative.available(), tnative.load_error()
    path = tnative.library_path()
    assert "/build/native/libbigdl_native_" in path
    assert tnative.SOURCE.name == "bigdl_native.cpp"
    assert "bigdl_tpu_torch/native" in str(tnative.SOURCE)


# ------------------------------------------------------------ image stages
_STAGES = {
    "GreyImgNormalizer": lambda m: m.GreyImgNormalizer(100.0, 50.0),
    "BGRImgNormalizer": lambda m: m.BGRImgNormalizer([100., 110., 120.],
                                                     [50., 55., 60.]),
    "BGRImgPixelNormalizer": lambda m: m.BGRImgPixelNormalizer(
        np.full((12, 14, 3), 90.0, np.float32)),
    "HFlip": lambda m: m.HFlip(0.5, seed=3),
    "BGRImgCropper": lambda m: m.BGRImgCropper(10, 8),
    "BGRImgRdmCropper": lambda m: m.BGRImgRdmCropper(10, 8, padding=2,
                                                     seed=4),
    "ColorJitter": lambda m: m.ColorJitter(seed=5),
    "Lighting": lambda m: m.Lighting(seed=6),
}


@pytest.mark.parametrize("name", sorted(_STAGES))
def test_image_stage_matches_jax(name):
    rs = np.random.RandomState(7)
    samples = [(rs.randint(0, 256, (12, 14, 3)).astype(np.float32), i)
               for i in range(6)]
    ref = list(_STAGES[name](jimage).apply(samples))
    got = list(_STAGES[name](timage).apply(samples))
    for (a, la), (b, lb) in zip(ref, got):
        assert la == lb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compute_mean_std_and_chaining_match_jax():
    imgs = np.random.RandomState(8).randint(0, 256, (5, 6, 7, 3)).astype(
        np.float32)
    for a, b in zip(jimage.compute_mean_std(imgs),
                    timage.compute_mean_std(imgs)):
        np.testing.assert_array_equal(a, b)
    samples = [(imgs[i], i) for i in range(5)]
    chain = lambda m: (m.BGRImgRdmCropper(4, 4, seed=1)  # noqa: E731
                       >> m.HFlip(seed=2))
    for (a, _), (b, _) in zip(chain(jimage).apply(samples),
                              chain(timage).apply(samples)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- plan
@pytest.mark.parametrize("mode,pi,pc", [("global", 0, 1), ("global", 1, 3),
                                        ("shard", 1, 2)])
def test_epoch_plan_matches_jax(mode, pi, pc):
    kw = dict(seed=3, mode=mode, process_index=pi, process_count=pc)
    a = jpipe.EpochPlan(50, 4, **kw)
    b = tpipe.EpochPlan(50, 4, **kw)
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(a.batch_indices(epoch),
                                      b.batch_indices(epoch))
    a.advance()
    b.advance()
    assert a.signature() == b.signature()
    assert b.steps == a.steps
    ns = tpipe.EpochPlan(50, 4, shuffle=False, **kw)
    np.testing.assert_array_equal(
        ns.batch_indices(2),
        jpipe.EpochPlan(50, 4, shuffle=False, **kw).batch_indices(2))


def test_plan_rank_from_torch_distributed_and_sample_rng():
    assert tpipe.process_rank() == (0, 1)  # no process group here
    p = tpipe.EpochPlan(10, 2)
    assert (p.pi, p.pc) == (0, 1)
    for seed, epoch, index in ((0, 0, 0), (7, 3, 11), (2 ** 31, 9, 5)):
        assert (jpipe.sample_rng(seed, epoch, index).randint(0, 2 ** 30, 4)
                == tpipe.sample_rng(seed, epoch, index).randint(
                    0, 2 ** 30, 4)).all()
    assert tdist.host_shard(10) == jdist.host_shard(10, 0, 1)
    assert tdist.host_shard(10, 1, 3) == jdist.host_shard(10, 1, 3)


def test_sharded_dataset_matches_jax():
    kw = dict(global_batch_size=16, shuffle=True, seed=5, process_index=1,
              process_count=2)
    _same(_stream(jdist.ShardedDataSet(_X, _Y, **kw)),
          _stream(tdist.ShardedDataSet(_X, _Y, **kw)))
    with pytest.raises(ValueError, match="not divisible"):
        tdist.ShardedDataSet(_X, _Y, 15, process_index=0, process_count=2)


# ---------------------------------------------------------------- executor
@pytest.mark.parametrize("workers", [1, 2, 8])
def test_executor_matches_jax(workers):
    """The executor's stream equals the JAX executor's (with the JAX
    package's worker count fixed at 4) for 1, 2 and 8 workers."""
    ref = _stream(jpipe.ExecutorDataSet(jpipe.ArraySampleSource(_X, _Y),
                                        batch_size=16, workers=4, seed=7))
    got = _stream(tpipe.ExecutorDataSet(tpipe.ArraySampleSource(_X, _Y),
                                        batch_size=16, workers=workers,
                                        seed=7))
    _same(ref, got)
    assert _no_pipe_threads()


def test_as_executor_matches_jax_for_each_dataset():
    for jmk, tmk in (
            (lambda: jds.BatchDataSet(_X, _Y, 16, shuffle=True),
             lambda: tds.BatchDataSet(_X, _Y, 16, shuffle=True)),
            (lambda: jdist.ShardedDataSet(_X, _Y, 16, shuffle=True, seed=4,
                                          process_index=0, process_count=1),
             lambda: tdist.ShardedDataSet(_X, _Y, 16, shuffle=True, seed=4,
                                          process_index=0,
                                          process_count=1))):
        ex = tpipe.as_executor(tmk(), workers=3, seed=9)
        assert isinstance(ex, tpipe.ExecutorDataSet)
        _same(_stream(jpipe.as_executor(jmk(), workers=3, seed=9)),
              _stream(ex))
    assert tpipe.as_executor(tds.LocalArrayDataSet([1, 2]), 2) is None


class _SlowSource(tpipe.ArraySampleSource):
    def load(self, index, epoch):
        time.sleep(0.002)
        return super().load(index, epoch)


class _PoisonSource(tpipe.ArraySampleSource):
    def load(self, index, epoch):
        if index == 5:
            raise ValueError("decode failed for sample 5")
        return super().load(index, epoch)


def test_executor_backpressure_errors_and_early_exit():
    ds = tpipe.ExecutorDataSet(_SlowSource(_X, _Y), batch_size=8,
                               workers=8, depth=2, seed=0)
    for _ in ds:
        time.sleep(0.01)  # a consumer slower than 8 workers
    assert 1 <= ds.stats["max_inflight"] <= 2
    assert ds.stats["batches"] == 8 and ds.stats["join_timeouts"] == 0
    ds = tpipe.ExecutorDataSet(_SlowSource(_X, _Y), batch_size=8,
                               workers=4, depth=2, seed=0)
    for i, _ in enumerate(ds):
        if i == 1:
            break  # the consumer leaves mid-epoch
    assert ds.stats["join_timeouts"] == 0 and _no_pipe_threads()
    ds = tpipe.ExecutorDataSet(_PoisonSource(_X, _Y), batch_size=8,
                               workers=4, depth=2, seed=0, shuffle=False)
    with pytest.raises(ValueError, match="sample 5"):
        list(ds)
    assert _no_pipe_threads()


# ----------------------------------------------------- staging and prefetch
def test_stage_host_on_the_cpu_and_off():
    def inner():
        return tpipe.ExecutorDataSet(tpipe.ArraySampleSource(_X, _Y),
                                     batch_size=16, workers=2, seed=0)

    staged = tpipe.StagedDataSet(inner(), stage="host", depth=2)
    assert staged.plan is staged.inner.plan
    # host mode on the CPU: prepared ahead, unpinned
    _same(_stream(inner()), _stream(staged))
    inner = inner()
    for mb in tpipe.StagedDataSet(inner, stage="off"):
        assert isinstance(mb, tds.MiniBatch)
        assert isinstance(mb.input, np.ndarray)
    assert _no_pipe_threads()


def test_stage_errors_reach_the_consumer_and_device_needs_cuda():
    def bad():
        yield tds.MiniBatch(_X[:4], _Y[:4])
        raise OSError("a shard went away")

    with pytest.raises(OSError, match="went away"):
        list(tpipe.staged_batches(bad(), stage="host"))
    with pytest.raises(OSError, match="went away"):
        list(tprefetch.PrefetchDataSet(_Gen(bad), 2))
    assert _no_pipe_threads()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpipe.StagedDataSet(tds.BatchDataSet(_X, _Y, 8), stage="device")
    with pytest.raises(ValueError, match="CUDA device, not cpu"):
        tpipe.StagedDataSet(tds.BatchDataSet(_X, _Y, 8), stage="device",
                            device="cpu")
    with pytest.raises(ValueError, match="stage must be one of"):
        tpipe.StagedDataSet(tds.BatchDataSet(_X, _Y, 8), stage="gpu")


class _Gen(tds.DataSet):
    def __init__(self, make):
        self.make = make

    def __iter__(self):
        return self.make()


def test_prefetch_matches_jax_and_joins():
    ref = _stream(jprefetch.PrefetchDataSet(
        jds.BatchDataSet(_X, _Y, 8, shuffle=True, seed=2), 3))
    got = _stream(tprefetch.PrefetchDataSet(
        tds.BatchDataSet(_X, _Y, 8, shuffle=True, seed=2), 3))
    _same(ref, got)
    for i, _ in enumerate(tprefetch.PrefetchDataSet(
            tds.BatchDataSet(_X, _Y, 8), 1)):
        if i == 0:
            break
    assert _no_pipe_threads()


def test_wrap_pipeline_and_build_feed_provenance():
    ds, prov = tpipe.wrap_pipeline(tds.BatchDataSet(_X, _Y, 16), workers=0,
                                   stage="off")
    assert prov is None and isinstance(ds, tds.BatchDataSet)
    ds, prov = tpipe.wrap_pipeline(tds.BatchDataSet(_X, _Y, 16, shuffle=True),
                                   workers=3, depth=4, stage="host", seed=7)
    jds_, jprov = jpipe.wrap_pipeline(
        jds.BatchDataSet(_X, _Y, 16, shuffle=True), workers=3, depth=4,
        stage="off", seed=7)
    assert isinstance(ds, tpipe.StagedDataSet)
    assert isinstance(ds.inner, tpipe.ExecutorDataSet)
    assert prov == dict(jprov, stage="host")
    _same(_stream(jds_), _stream(ds))
    ds, prov = tpipe.wrap_pipeline(tds.LocalArrayDataSet([1, 2, 3]),
                                   workers=2)
    assert isinstance(ds, tprefetch.PrefetchDataSet)
    assert prov["executor"] is False
    assert common.PIPELINE_STAGE_CHOICES == tpipe.STAGE_CHOICES == \
        jpipe.STAGE_CHOICES
    # no downgrade of --stage device under --stepsPerDispatch (a stated
    # difference from the JAX CLI): here it reaches the staging layer,
    # which needs CUDA
    import argparse
    p = argparse.ArgumentParser()
    common.add_train_args(p)
    args = p.parse_args(["--dataWorkers", "2", "--stage", "host",
                         "--stepsPerDispatch", "4", "--platform", "cpu"])
    ds, prov = common.build_feed(tds.BatchDataSet(_X, _Y, 16), args)
    assert prov["stage"] == "host" and args._pipeline is prov
    args = p.parse_args(["--stage", "device", "--stepsPerDispatch", "4",
                         "--platform", "cpu"])
    with pytest.raises(ValueError, match="CUDA device, not cpu"):
        common.build_feed(tds.BatchDataSet(_X, _Y, 16), args)


@pytest.mark.cuda
def test_stage_device_on_the_card():
    """--stage device: DeviceBatches on the card, each equal to its host
    batch, and an Optimizer fed by them (graphed, K = 2) takes the same
    steps as one fed host batches."""
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    inner = tpipe.ExecutorDataSet(tpipe.ArraySampleSource(_X, _Y),
                                  batch_size=16, workers=2, seed=0)
    ref = _stream(inner, 1)
    got = []
    for mb in tpipe.StagedDataSet(inner, stage="device"):
        assert isinstance(mb, tpipe.DeviceBatch)
        x, y = mb.claim()
        got.append((x.cpu().numpy(), y.cpu().numpy()))
    inner.shuffle()
    _same(ref, got)


# ------------------------------------------------------------------ mixup
def test_mixup_and_cutmix_match_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(6, 16, 16, 3).astype(np.float32)
    y = np.arange(6, dtype=np.int32)
    for name, kw in (("Mixup", dict(alpha=0.4, seed=1)),
                     ("CutMix", dict(alpha=1.0, seed=4))):
        ref = list(getattr(jmixup, name)(**kw)(
            [jds.MiniBatch(x, y), jds.MiniBatch(x[::-1], y)]))
        got = list(getattr(tmixup, name)(**kw)(
            [tds.MiniBatch(x, y), tds.MiniBatch(x[::-1], y)]))
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a.input, b.input)
            for ta, tb in zip(a.target, b.target):
                np.testing.assert_array_equal(ta, tb)
    # the criterion: lam * L(y_a) + (1 - lam) * L(y_b), f32 at 1e-6
    logp = rs.randn(6, 6).astype(np.float32)
    ya, yb, lam = got[0].target
    jv = float(jmixup.MixupCriterion(jnn.ClassNLLCriterion())(
        jax.nn.log_softmax(logp), (ya, yb, lam)))
    tv = float(tmixup.MixupCriterion(nn.ClassNLLCriterion())(
        torch.log_softmax(torch.from_numpy(logp), -1),
        (torch.from_numpy(ya), torch.from_numpy(yb), torch.tensor(lam))))
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_mixup_feeds_the_optimizer():
    """Mixed batches (a (y_a, y_b, lam) target) through the port's loop."""
    ds = tds.BatchDataSet(np.random.RandomState(1).randn(16, 32, 32, 3)
                          .astype(np.float32), _Y[:16] % 10, 8)
    opt = Optimizer(models.resnet_cifar(8), ds >> tmixup.Mixup(seed=2),
                    tmixup.MixupCriterion(nn.ClassNLLCriterion()),
                    optim_method=SGD(0.05),
                    end_when=Trigger.max_iteration(2), device="cpu")
    opt.optimize()


# ------------------------------------------------------------- checkpoints
def _images(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


class _Recording:
    """A criterion that records each step's loss and targets."""

    def __init__(self, crit):
        self.crit, self.losses, self.targets = crit, [], []

    def __call__(self, out, target):
        loss = self.crit(out, target)
        self.losses.append(float(loss.detach()))
        self.targets.append(np.asarray(target))
        return loss


def test_jax_executor_checkpoint_resumed_by_the_port(tmp_path, caplog):
    """A JAX Optimizer fed by the executor checkpoints at iteration 3 of
    6-batch epochs (its driver holds the plan: 13 leaves); the port reads
    the plan, resumes with the same counters, takes the same next batches
    and tracks the JAX run's losses."""
    jm = jax_models.resnet_cifar(8)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(14)))
    state = jax.tree_util.tree_map(np.asarray, jm.init_state())
    x, y = _images(24, 13)

    def jax_run(end, ckpt=None):
        opt = joptim.Optimizer(
            jm, jpipe.ExecutorDataSet(jpipe.ArraySampleSource(x, y),
                                      batch_size=4, workers=2, seed=7),
            jnn.ClassNLLCriterion(), optim_method=joptim.SGD(0.1,
                                                             momentum=0.9),
            end_when=joptim.Trigger.max_iteration(end))
        opt.set_state(params=params, mod_state=state)
        summ = tmp_path / f"summary{end}"
        opt.set_summary(str(summ))
        if ckpt:
            opt.set_checkpoint(joptim.Trigger.several_iteration(3),
                               str(ckpt))
        opt.optimize()
        import json
        return [json.loads(ln)["loss"] for ln in
                (summ / "train.jsonl").read_text().splitlines()]

    ref = jax_run(6)
    jax_run(3, tmp_path / "ck")
    _, driver = load_model(str(tmp_path / "ck" / "model.3"),
                           models.resnet_cifar(8))
    assert set(driver["plan"]) == set(PLAN_KEYS)
    assert driver["plan"]["mode"] == "global" and driver["plan"]["n"] == 24
    assert (driver["iteration"], driver["epoch"],
            driver["epoch_records"]) == (3, 1, 12)
    feed = tpipe.ExecutorDataSet(tpipe.ArraySampleSource(x, y),
                                 batch_size=4, workers=3, seed=7)
    order = feed.plan.batch_indices(0)
    rec = _Recording(nn.ClassNLLCriterion())
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    Optimizer(models.resnet_cifar(8), feed, rec,
              optim_method=SGD(0.1, momentum=0.9),
              end_when=Trigger.max_iteration(6), device="cpu").resume(
        str(tmp_path / "ck")).optimize()
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Resuming at epoch 1, iteration 3") for m in msgs)
    assert not any("differs from this run's" in m for m in msgs)
    for t, row in zip(rec.targets, order[3:6]):
        np.testing.assert_array_equal(t, y[row])
    np.testing.assert_allclose(rec.losses, ref[3:], rtol=0, atol=LOSS_ATOL)


def test_port_executor_checkpoint_roundtrips_plan_and_resumes(tmp_path,
                                                              caplog):
    """The port's own kill at 4 (mid-epoch, 6-batch epochs, two steps a
    dispatch) and resume to 8 through the executor and a host staging
    thread: bit for bit the uninterrupted run; the blob's plan is the
    executor's signature; a run with another plan warns."""
    x, y = _images(24, 3)

    def run(end, ckpt=None, resume=None, seed=7):
        feed = tpipe.StagedDataSet(tpipe.ExecutorDataSet(
            tpipe.ArraySampleSource(x, y), batch_size=4, workers=2,
            seed=seed), stage="host")
        rec = _Recording(nn.ClassNLLCriterion())
        opt = Optimizer(models.resnet_cifar(8, generator=torch.Generator()
                                            .manual_seed(0)), feed, rec,
                        optim_method=SGD(0.1, momentum=0.9),
                        end_when=Trigger.max_iteration(end), device="cpu",
                        steps_per_dispatch=2)
        if ckpt:
            opt.set_checkpoint(Trigger.several_iteration(4), str(ckpt))
        if resume:
            opt.resume(str(resume))
        opt.optimize()
        return rec.losses, feed

    full, _ = run(8)
    head, feed = run(4, ckpt=tmp_path / "ck")
    _, driver = load_model(str(tmp_path / "ck" / "model.4"),
                           models.resnet_cifar(8))
    assert driver["plan"] == dict(feed.plan.signature(), epoch=0)
    assert driver["epoch_records"] == 16
    caplog.set_level(logging.WARNING, logger="bigdl_tpu_torch")
    tail, _ = run(8, resume=tmp_path / "ck")
    assert head + tail == full
    assert not caplog.records
    run(6, resume=tmp_path / "ck", seed=8)
    assert any("differs from this run's" in r.getMessage()
               for r in caplog.records)


def test_pipeline_flags_on_the_lm_cli(tmp_path, caplog):
    """``cli.transformerlm train`` takes --dataWorkers/--prefetchDepth/
    --stage: its BatchDataSet runs behind the executor and a host staging
    thread."""
    from bigdl_tpu_torch.cli import transformerlm as lm_cli

    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    rs = np.random.RandomState(0)
    (tmp_path / "input.txt").write_text(" ".join(
        " ".join(rs.choice(words, 6)) + " ." for _ in range(60)))
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    lm_cli.main(["train", "-f", str(tmp_path), "--platform", "cpu",
                 "--dModel", "16", "--numLayers", "1", "--numHeads", "2",
                 "--seqLength", "16", "-b", "4", "--maxEpoch", "1",
                 "--logEvery", "1", "--dataWorkers", "2", "--prefetchDepth",
                 "3", "--stage", "host"])
    losses = [float(r.getMessage().rsplit(" ", 1)[1]) for r in caplog.records
              if r.getMessage().startswith("Train 4 in ")]
    assert losses and all(np.isfinite(losses))
    assert _no_pipe_threads()
