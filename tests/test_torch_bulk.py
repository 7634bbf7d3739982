"""The port's offline bulk inference (``serving/bulk.py``, ``cli/
batch_predict.py``) against the JAX package's on the CPU.

Held: the shard sink's and the cursor's bytes equal the JAX functions'
for the same preds and scores; ``run_bulk``'s kill and resume give
byte-identical shards; a drifted feed and a changed group count are
refused; ``batch-predict`` over 22 seeded records of ``resnet20_cifar``
at ``-b 4`` (5 batches and a tail of 2), with weights from a checkpoint
the JAX package wrote, at dp:1 and at dp:2 on ``cpu,cpu``, against the
JAX ``InferenceEngine`` driven by hand over the same eval-mode source
(the JAX test's ``reference``): every record once, scores within 1e-4
relative, preds equal where the JAX top-2 margin exceeds 1e-4; the CLI
killed mid-job resumes byte-identical to an uninterrupted run.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.serving import bulk as jax_bulk
from bigdl_tpu_torch.serving import bulk

B = 4          # 22 records -> 5 full batches + a tail of 2
CLASSES = 10
N = 22
SCORE_RTOL = 1e-4  # of max|score|, the JAX engine's f32 against the port's
MARGIN = 1e-4      # preds compared where the JAX top-2 margin exceeds this


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ sink and cursor
def test_shard_and_cursor_bytes_equal_jax(tmp_path):
    """The same preds and scores written through the port's ShardSink and
    the JAX one give the same bytes; a resume offset truncates alike; the
    cursors' bytes are equal."""
    rs = np.random.RandomState(0)
    scores = rs.randn(5, 3).astype(np.float32)
    files = []
    for name, mod in (("port", bulk), ("jax", jax_bulk)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "scores-00000-of-00001.jsonl")
        sink = mod.ShardSink(path)
        sink.write_batch([0, 1], [2, 0], scores[:2])
        sink.flush()
        mid = sink.offset
        sink.write_batch([2, 3, 4], [1, 1, 2])
        sink.close()
        sink = mod.ShardSink(path, resume_offset=mid)
        sink.write_batch([2, 3, 4], [1, 1, 2], scores[2:])
        sink.close()
        mod.save_cursor(str(d), {"plan": {"n": 5}, "scores": True}, 2,
                        [sink.offset], 5)
        with open(path, "rb") as f, open(d / "cursor.json", "rb") as g:
            files.append((f.read(), g.read()))
        assert [r["i"] for r in mod.merge_shards(str(d))] == list(range(5))
    assert files[0] == files[1]
    assert files[0][0].decode().splitlines()[0] == json.dumps(
        {"i": 0, "pred": 2, "scores": [float(v) for v in
                                       np.asarray(scores[0], np.float64)]},
        sort_keys=True)
    assert bulk.shard_paths("o", 2) == jax_bulk.shard_paths("o", 2)


class _FakeEngine:
    """A deterministic stand-in for InferenceEngine.predict_scores."""

    def predict_scores(self, x):
        flat = np.asarray(x, np.float64).reshape(len(x), -1)
        return np.stack([flat[:, :5].sum(axis=1),
                         flat[:, 5:10].sum(axis=1)], axis=1)


def _fake_feed(n_batches=6, batch=4):
    for s in range(n_batches):
        idx = np.arange(s * batch, (s + 1) * batch)
        x = ((idx[:, None] * 13 + np.arange(12)) % 7).astype(np.float32)
        yield s, idx, x


_SIG = {"plan": {"n": 24, "batch": 4}, "scores": True}


def _read_shards(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("scores-") or name == bulk.CURSOR_FILE:
            with open(os.path.join(out_dir, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("groups", [1, 2])
def test_run_bulk_kill_resume_byte_identical(groups, tmp_path):
    """Killed after the second barrier's cursor (batch 3 raises in the
    feed's hook, batches past the barrier already in a shard), resumed:
    the shards and the cursor equal an uninterrupted run's and the JAX
    run_bulk's on the same feed, byte for byte."""
    a, b, j = (str(tmp_path / n) for n in "abj")
    engines = [_FakeEngine() for _ in range(groups)]
    ref = bulk.run_bulk(engines, _fake_feed(), dict(_SIG), a, scores=True,
                        checkpoint_every=2)
    assert ref["records"] == 24 and ref["resumed_from_batch"] == 0
    jax_bulk.run_bulk(engines, _fake_feed(), dict(_SIG), j, scores=True,
                      checkpoint_every=2)

    def _kill(ordinal):
        if ordinal >= 3:
            raise RuntimeError("simulated kill")

    with pytest.raises(RuntimeError, match="simulated kill"):
        bulk.run_bulk(engines, _fake_feed(), dict(_SIG), b, scores=True,
                      checkpoint_every=2, on_batch=_kill)
    assert bulk.load_cursor(b)["next_batch"] == 2  # the last barrier
    rep = bulk.run_bulk(engines, _fake_feed(), dict(_SIG), b, scores=True,
                        checkpoint_every=2)
    assert rep["resumed_from_batch"] == 2
    assert rep["batches_scored_this_run"] == 4  # 2..5, not 0-1 again
    assert rep["records"] == 24
    assert _read_shards(b) == _read_shards(a) == _read_shards(j)


def test_run_bulk_refuses_drifted_feed_and_dead_worker(tmp_path):
    out = str(tmp_path / "o")
    bulk.run_bulk([_FakeEngine()], _fake_feed(), dict(_SIG), out,
                  scores=True, checkpoint_every=2)
    with pytest.raises(ValueError, match="different feed"):
        bulk.run_bulk([_FakeEngine()], _fake_feed(),
                      {**_SIG, "scores": False}, out, checkpoint_every=2)
    with pytest.raises(ValueError, match="changed --strategy"):
        bulk.run_bulk([_FakeEngine(), _FakeEngine()], _fake_feed(),
                      dict(_SIG), out, scores=True, checkpoint_every=2)

    class Dead:
        def predict_scores(self, x):
            raise OSError("engine died")

    # a dead worker fails the job at the next dispatch or barrier; it
    # never blocks on a full queue
    with pytest.raises(OSError, match="engine died"):
        bulk.run_bulk([Dead()], _fake_feed(60), dict(_SIG),
                      str(tmp_path / "d"), checkpoint_every=1000)


# ---------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """22 seeded PNG records in shards of 8, and a JAX checkpoint of
    ``resnet20_cifar`` (its init, running statistics perturbed)."""
    from PIL import Image

    from bigdl_tpu.cli.perf import build_model as jax_build
    from bigdl_tpu.utils.file import save_pytree
    from bigdl_tpu_torch.dataset.recordfile import write_image_shards

    root = tmp_path_factory.mktemp("bulk")
    rng = np.random.RandomState(0)
    for cls in ("a", "b"):
        d = root / "imgs" / cls
        d.mkdir(parents=True)
        for i in range(N // 2):
            Image.fromarray(rng.randint(0, 255, (40, 48, 3)).astype(
                np.uint8)).save(d / f"{i}.png")
    shards = str(root / "shards")
    write_image_shards(str(root / "imgs"), shards, images_per_shard=8)
    jm, _ = jax_build("resnet20_cifar", class_num=CLASSES)
    params = jm.init(jax.random.PRNGKey(3))
    state = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.1) * rng.rand(
            *np.shape(a)).astype(np.float32), jm.init_state())
    ck = str(root / "ckpt" / "model.1")
    save_pytree({"params": params, "mod_state": state}, ck)
    return shards, jm, params, state, os.path.dirname(ck)


@pytest.fixture(scope="module")
def reference(records):
    """Preds and scores of the JAX engine driven by hand over the same
    eval-mode source in the plan's batch chunking (the JAX test's
    ``reference``)."""
    from bigdl_tpu.cli.perf import _short_side
    from bigdl_tpu.dataset.pipeline import StreamingSampleSource
    from bigdl_tpu.dataset.streaming import RecordImageDataSet
    from bigdl_tpu.serving import InferenceEngine, power_of_two_buckets
    from bigdl_tpu.serving.sharding import (replica_device_groups,
                                            serving_mesh)

    shards, jm, params, state, _ = records
    rds = RecordImageDataSet(shards, batch_size=B, crop=(32, 32),
                             train=False, short_side=_short_side((32, 32)),
                             mean=[123.68, 116.779, 103.939],
                             std=[58.4, 57.1, 57.4], n_threads=1, window=1)
    src = StreamingSampleSource(rds)
    assert len(src) == N
    eng = InferenceEngine(jm, params, state,
                          buckets=power_of_two_buckets(B),
                          mesh=serving_mesh(replica_device_groups(1, 1)[0]))
    scores = []
    for s in range(0, N, B):
        mb = src.collate([src.load(i, 0) for i in range(s, min(s + B, N))])
        scores.append(np.asarray(eng.predict_scores(mb.input), np.float64))
    return np.concatenate(scores)


def _cli(records, out, *extra):
    from bigdl_tpu_torch.cli import main as cli_main
    from bigdl_tpu_torch.cli import batch_predict
    argv = ["--modelName", "resnet20_cifar", "--model", records[4],
            "-f", f"record:{records[0]}", "--out", str(out), "-b", str(B),
            "--classNum", str(CLASSES), "--checkpointEvery", "2",
            "--platform", "cpu", "--scores", *extra]
    if not extra:  # the launcher's spelling once
        assert cli_main.main(["batch-predict"] + argv) == 0
        return json.loads(open(os.path.join(out, bulk.CURSOR_FILE)).read())
    return batch_predict.main(argv)


def _check_against(rows, reference):
    assert [r["i"] for r in rows] == list(range(N))  # every record once
    got = np.asarray([r["scores"] for r in rows], np.float64)
    np.testing.assert_allclose(got, reference, rtol=0,
                               atol=SCORE_RTOL * np.abs(reference).max())
    top2 = np.sort(reference, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > MARGIN
    preds = np.asarray([r["pred"] for r in rows])
    assert sure.sum() >= N // 2
    assert (preds[sure] == reference.argmax(-1)[sure]).all()


@pytest.mark.parametrize("strategy", ["dp:1", "dp:2"])
def test_cli_matches_jax_engine(strategy, records, reference, tmp_path):
    """``batch-predict`` with the JAX checkpoint, the executor feed with 2
    workers and host staging, dp:1 and dp:2 on ``cpu,cpu``: against the
    JAX engine by hand, the tail included; dp:2 deals ordinal s to shard
    s % 2."""
    rep = _cli(records, tmp_path, "--strategy", strategy, "--devices",
               "cpu,cpu", "--dataWorkers", "2", "--stage", "host")
    groups = int(strategy[-1])
    assert rep["records"] == N and rep["batches"] == 6
    assert rep["groups"] == groups and rep["chips"] == groups
    assert rep["pipeline"]["workers"] == 2
    assert rep["bn_fused"] == "off" and rep["stall_frac"] is None
    _check_against(bulk.merge_shards(str(tmp_path)), reference)
    if groups == 2:
        with open(bulk.shard_paths(str(tmp_path), 2)[1]) as f:
            assert [json.loads(ln)["i"] for ln in f][:4] == [4, 5, 6, 7]


def test_cli_kill_resume_byte_identical(records, reference, tmp_path,
                                        monkeypatch):
    """The CLI killed mid-job (the feed's hook raises at batch 3), then
    the same command again: shards and cursor byte-identical to an
    uninterrupted run's, batches 0-1 not scored again."""
    pristine, killed = tmp_path / "a", tmp_path / "b"
    cur = _cli(records, pristine)
    assert cur["next_batch"] == 6 and cur["records_done"] == N
    orig = bulk.run_bulk

    def with_kill(engines, feed, signature, out_dir, **kw):
        def boom(ordinal):
            if ordinal >= 3:
                raise RuntimeError("simulated kill")
        kw["on_batch"] = boom
        return orig(engines, feed, signature, out_dir, **kw)

    monkeypatch.setattr(bulk, "run_bulk", with_kill)
    with pytest.raises(RuntimeError, match="simulated kill"):
        _cli(records, killed, "--dataWorkers", "1")
    monkeypatch.setattr(bulk, "run_bulk", orig)
    rep = _cli(records, killed, "--dataWorkers", "1")
    assert rep["resumed_from_batch"] == 2
    assert rep["records"] == N and rep["records_scored_this_run"] == N - 8
    assert _read_shards(str(killed)) == _read_shards(str(pristine))
    _check_against(bulk.merge_shards(str(killed)), reference)
