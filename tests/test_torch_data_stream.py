"""The port's record shards, streaming image datasets, image folders and
the CIFAR CLI feed against the JAX package's, on the CPU, over small
seeded trees in ``tmp_path``: JPEGs decode through libjpeg (the port's
native library and the JAX package's, built from the same source), PNGs
through PIL. Every comparison is bit for bit."""

import io
import os

import numpy as np
import pytest

from bigdl_tpu.cli import vgg as jax_vgg_cli
from bigdl_tpu.dataset import folder as jfolder
from bigdl_tpu.dataset import native as jnative
from bigdl_tpu.dataset import pipeline as jpipe
from bigdl_tpu.dataset import recordfile as jrf
from bigdl_tpu.dataset import streaming as jstream
from bigdl_tpu_torch.cli import perf
from bigdl_tpu_torch.cli import resnet as resnet_cli
from bigdl_tpu_torch.dataset import folder as tfolder
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import pipeline as tpipe
from bigdl_tpu_torch.dataset import recordfile as trf
from bigdl_tpu_torch.dataset import streaming as tstream


def _stream(ds, epochs=2, advance=True):
    out = []
    for _ in range(epochs):
        for mb in ds:
            out.append((np.array(mb.input), np.array(mb.target)))
        if advance:
            ds.shuffle()
    return out


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.fixture(scope="module")
def jpeg():
    if not (jnative.jpeg_available() and tnative.jpeg_available()):
        pytest.skip("native lib built without libjpeg")


def _tree(root, ext, classes=("ant", "bee", "cow"), per=5, seed=0):
    """root/<class>/<i>.<ext>: seeded noise images of a few sizes."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for cls in classes:
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(per):
            arr = rng.randint(0, 256, (36 + 3 * i, 44, 3)).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, cls, f"{i}.{ext}"),
                                      **({"quality": 90} if ext == "jpg"
                                         else {}))
    return root


# ------------------------------------------------------------ record files
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_shards_read_by_the_other_package(tmp_path, writer):
    src = _tree(str(tmp_path / "imgs"), "png")
    w, r = (jrf, trf) if writer == "jax" else (trf, jrf)
    shards = w.write_image_shards(src, str(tmp_path / "rec"), prefix="t",
                                  images_per_shard=4, workers=2)
    assert [os.path.basename(p) for p in shards] == [
        f"t-0000{i}-of-00004.btr" for i in range(4)]
    other = str(tmp_path / "rec2")
    r.write_image_shards(src, other, prefix="t", images_per_shard=4)
    for a, b in zip(shards, r.list_shards(other)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()  # byte for byte the same shard
        with r.RecordReader(a) as ra, w.RecordReader(b) as rb:
            assert list(ra) == list(rb)
            label, img = r.unpack_image_record(ra.read(len(ra) - 1))
            assert w.pack_image_record(label, img) == ra.read(len(ra) - 1)
    bad = tmp_path / "bad.btr"
    bad.write_bytes(b"this is not a record file, but long enough......")
    with pytest.raises(IOError):
        trf.RecordReader(str(bad))


@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("train", [True, False])
def test_record_image_dataset_matches_jax(tmp_path, jpeg, ext, train):
    """RecordImageDataSet over two epochs (per-sample random crop and flip
    when training, scale-to-fill and centre crop otherwise), and the
    executor over it with 4 workers, against the JAX package's."""
    src = _tree(str(tmp_path / "imgs"), ext)
    shards = jrf.write_image_shards(src, str(tmp_path / "rec"),
                                    images_per_shard=4)
    kw = dict(batch_size=4, crop=(24, 24), train=train, seed=11,
              mean=[120.0, 115.0, 100.0], std=[58.0, 57.0, 57.0],
              n_threads=3, window=2)
    ref = _stream(jstream.RecordImageDataSet(shards, **kw), advance=False)
    got = _stream(tstream.RecordImageDataSet(str(tmp_path / "rec"), **kw),
                  advance=False)
    _same(ref, got)
    assert got[0][0].shape == (4, 24, 24, 3)
    ex = tpipe.as_executor(tstream.RecordImageDataSet(shards, **kw),
                           workers=4)
    assert isinstance(ex, tpipe.ExecutorDataSet)
    got_ex = _stream(ex)
    _same(_stream(jpipe.as_executor(jstream.RecordImageDataSet(shards, **kw),
                                    workers=2)), got_ex)
    _same(ref, got_ex)  # the executor feeds the record set's own epochs


def test_record_partition_caps_batches_as_jax(tmp_path):
    src = _tree(str(tmp_path / "imgs"), "png", per=4)
    shards = jrf.write_image_shards(src, str(tmp_path / "rec"),
                                    images_per_shard=5)
    kw = dict(batch_size=2, crop=(20, 20), shard=(1, 2), n_threads=2)
    _same(_stream(jstream.RecordImageDataSet(shards, **kw), 1, False),
          _stream(tstream.RecordImageDataSet(shards, **kw), 1, False))
    assert tpipe.as_executor(tstream.RecordImageDataSet(shards, **kw),
                             2) is None


def test_decode_paths_match_jax(jpeg):
    from PIL import Image

    g = np.linspace(0, 255, 120 * 150).reshape(120, 150)
    arr = np.stack([g, g[::-1], (g + g[::-1]) / 2], -1).astype(np.uint8)
    for fmt in ("JPEG", "PNG"):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        raw = buf.getvalue()
        for kw in (dict(short_side=64), dict(short_side=None,
                                             fill=(40, 50))):
            a = jstream.decode_resize(raw, **kw)
            b = tstream.decode_resize(raw, **kw)
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert tnative.decode_jpeg(b"\xff\xd8garbage", short_side=64) is None
    img = arr[:40, :60]
    outs = []
    for mod in (jstream, tstream):
        aug = mod.random_resized_crop((24, 24))
        outs.append(aug(img, np.random.RandomState(3)))
    np.testing.assert_array_equal(outs[0], outs[1])


# ------------------------------------------------------------ image folders
@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("train", [True, False])
def test_image_folder_dataset_matches_jax(tmp_path, jpeg, ext, train):
    src = _tree(str(tmp_path / "imgs"), ext)
    kw = dict(size=(24, 24), train=train, mean=tfolder.IMAGENET_MEAN,
              std=tfolder.IMAGENET_STD, seed=2, n_threads=2)
    assert tfolder.IMAGENET_MEAN == jfolder.IMAGENET_MEAN
    assert tfolder.IMAGENET_STD == jfolder.IMAGENET_STD
    _same(_stream(jfolder.ImageFolderDataSet(src, 4, **kw), advance=False),
          _stream(tfolder.ImageFolderDataSet(src, 4, **kw), advance=False))
    pa, la, ca = jfolder.list_image_folder(src)
    pb, lb, cb = tfolder.list_image_folder(src)
    assert (pa, ca) == (pb, cb) and (la == lb).all()
    for a, b in zip(jfolder.load_image_folder(src, size=(20, 22)),
                    tfolder.load_image_folder(src, size=(20, 22))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- the CLIs
def _write_cifar(folder, n, seed):
    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                              rs.randint(0, 256, (n, 3072))], axis=1)
        rec.astype(np.uint8).tofile(os.path.join(folder, name))


@pytest.mark.parametrize("train", [True, False])
def test_cifar_cli_batches_equal_the_jax_clis(tmp_path, train):
    """``cli.resnet train --dataset cifar10`` feeds the JAX CLI's batches:
    shuffled, randomly cropped (at the full 32 x 32) and flipped, then
    normalised; the test split in order, unflipped."""
    if not jnative.available():
        pytest.skip("the JAX package's native lib is unavailable")
    _write_cifar(str(tmp_path), 24, seed=5)
    _same(_stream(jax_vgg_cli._one_split(str(tmp_path), 16, train, train)),
          _stream(resnet_cli._one_split(str(tmp_path), 16, train, train)))


def test_perf_record_feed_provenance(tmp_path, jpeg):
    src = _tree(str(tmp_path / "imgs"), "jpg", per=3)
    trf.write_image_shards(src, str(tmp_path / "rec"), images_per_shard=4)
    feed, prov = perf.record_feed(str(tmp_path / "rec"), 4, crop=(32, 32),
                                  workers=2, stage="host")
    mb = next(feed)
    assert mb.input.shape == (4, 32, 32, 3)
    assert prov["workers"] == 2 and prov["stage"] == "host"
    assert prov["signature"]["plan"]["batch"] == 4
    feed.close()
    feed, prov = perf.record_feed(str(tmp_path / "rec"), 4, crop=(32, 32))
    assert prov is None and next(feed).input.shape == (4, 32, 32, 3)
    feed.close()
    out = perf.main(["-m", "resnet20_cifar", "--platform", "cpu", "-b", "4",
                     "-i", "2", "--f32", "--data",
                     f"record:{tmp_path / 'rec'}", "--dataWorkers", "2",
                     "--prefetchDepth", "3", "--stage", "host"])
    assert out["pipeline"]["depth"] == 3 and out["inner_steps"] == 1
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
