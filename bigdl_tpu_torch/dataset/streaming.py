"""Streaming image input with per-sample augmentation (counterpart of
``bigdl_tpu/dataset/streaming.py``).

The ImageNet-scale training path (reference
image/MTLabeledBGRImgToBatch.scala:48-133 feeding
models/inception/ImageNet2012.scala:28-64): a pool of worker threads
decodes images and applies per-sample random crop, horizontal flip and
normalisation, assembling fixed-shape float batches while the card runs
the previous step, without holding the dataset in memory.

Division of labour per sample:
* JPEG decode: the port's native library (libjpeg with DCT scaling, then
  bilinear; ``bt_decode_jpeg``), GIL released, where the library was built
  with libjpeg; PIL for every other format and where it was not;
* crop/flip/normalise: one pass in C (``bt_augment_sample``), GIL
  released; numpy where the library is unavailable (the same float32
  arithmetic, so the same bits);
* crop offsets and flip coin: a per-(epoch, sample) seeded host generator,
  so a batch is bit-reproducible whatever thread ran each sample.

Batches are delivered in order through a bounded sliding window of
per-sample futures. Sources: :class:`StreamingImageFolder` (files on disk)
and :class:`RecordImageDataSet` (sharded record files,
``bigdl_tpu_torch.dataset.recordfile``).
"""

from __future__ import annotations

import io
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset import recordfile as rf
from bigdl_tpu_torch.dataset.dataset import DataSet, MiniBatch

__all__ = ["StreamingImageFolder", "RecordImageDataSet",
           "decode_resize", "augment_sample", "random_resized_crop"]


def random_resized_crop(target: tuple[int, int],
                        scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3),
                        attempts: int = 10):
    """Inception-style train augmentation: sample a crop covering a
    random area fraction at a random aspect ratio, resized to ``target``
    (reference-era pipelines use fixed-scale random crops; this is the
    modern ImageNet recipe). Returns an ``augment`` callable for the
    streaming datasets — pair with ``short_side=None`` disabled cropping
    by setting the dataset ``crop=target`` (the final center/random crop
    then becomes a no-op on an exactly-target-sized image).

    Usage::

        ds = RecordImageDataSet(shards, batch, crop=(224, 224),
                                train=True, short_side=256,
                                augment=random_resized_crop((224, 224)))
    """
    th, tw = target

    def aug(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        from PIL import Image

        h, w = img.shape[:2]
        area = h * w
        for _ in range(attempts):
            a = rng.uniform(*scale) * area
            log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
            r = float(np.exp(log_r))
            cw = int(round(np.sqrt(a * r)))
            ch = int(round(np.sqrt(a / r)))
            if cw <= w and ch <= h:
                y0 = rng.randint(0, h - ch + 1)
                x0 = rng.randint(0, w - cw + 1)
                crop = img[y0:y0 + ch, x0:x0 + cw]
                break
        else:  # fallback: center crop of the largest fitting window
            cw = ch = min(h, w)
            y0, x0 = (h - ch) // 2, (w - cw) // 2
            crop = img[y0:y0 + ch, x0:x0 + cw]
        if crop.shape[:2] != (th, tw):
            crop = np.asarray(
                Image.fromarray(crop).resize((tw, th), Image.BILINEAR))
        return crop

    return aug


def decode_resize(raw: bytes, short_side: Optional[int],
                  fill: Optional[tuple[int, int]] = None) -> np.ndarray:
    """Decode encoded image bytes -> RGB uint8 HWC, resized.

    ``short_side`` given: scale so min(h, w) == short_side (the train
    convention — leaves room for random crops). Else ``fill`` (th, tw):
    scale so the crop fills the image (the eval scale-to-fill convention of
    the folder loader and of the reference BGRImage.readImage).

    JPEG sources decode in C (libjpeg + DCT scaling + bilinear,
    ``bt_decode_jpeg`` of the port's native library) when the library was
    built with libjpeg: the whole decode runs without the GIL, so the
    worker pool scales across cores. PIL serves every other case.
    """
    if raw[:2] == b"\xff\xd8":  # JPEG magic
        from bigdl_tpu_torch.dataset import native

        img = native.decode_jpeg(raw, short_side=short_side,
                                 fill=None if short_side else fill)
        if img is not None:
            return img

    from PIL import Image

    with Image.open(io.BytesIO(raw)) as im:
        if short_side is not None:
            # JPEG draft mode: the decoder downscales during DCT — the
            # single biggest win in a JPEG input pipeline
            im.draft("RGB", (short_side, short_side))
            scale = short_side / min(im.width, im.height)
            tw = max(short_side, int(round(im.width * scale)))
            th = max(short_side, int(round(im.height * scale)))
        else:
            fh, fw = fill
            im.draft("RGB", (fw, fh))
            scale = max(fh / im.height, fw / im.width)
            tw = max(fw, int(round(im.width * scale)))
            th = max(fh, int(round(im.height * scale)))
        im = im.convert("RGB")
        if (tw, th) != im.size:
            im = im.resize((tw, th))
        return np.asarray(im, dtype=np.uint8)


def augment_sample(img: np.ndarray, crop: tuple[int, int],
                   mean: np.ndarray, std: np.ndarray,
                   rng: Optional[np.random.RandomState],
                   hflip: bool) -> np.ndarray:
    """Crop (random when ``rng`` given, else center) + optional flip +
    per-channel normalize. One C pass when the native lib is loadable."""
    ch, cw = crop
    h, w = img.shape[:2]
    if h < ch or w < cw:
        # validate before either backend: the C path would reject this and
        # the numpy path would silently mis-crop
        raise ValueError(
            f"crop {crop} larger than decoded image ({h}, {w}) — is "
            f"short_side smaller than the crop?")
    if rng is not None:
        off_h = rng.randint(0, h - ch + 1) if h > ch else 0
        off_w = rng.randint(0, w - cw + 1) if w > cw else 0
        flip = hflip and rng.rand() < 0.5
    else:
        off_h, off_w = (h - ch) // 2, (w - cw) // 2
        flip = False

    from bigdl_tpu_torch.dataset import native

    if native.available():
        img = np.ascontiguousarray(img)
        out = np.empty((ch, cw, img.shape[2]), np.float32)
        native.augment_sample_native(img, out, off_h, off_w, flip,
                                     mean, std)
        return out
    cropped = img[off_h:off_h + ch, off_w:off_w + cw]
    if flip:
        cropped = cropped[:, ::-1]
    return (cropped.astype(np.float32) - mean) / std


class _StreamingImageBase(DataSet):
    """Shared pool/window/permutation machinery; subclasses supply
    ``_read_raw(j) -> (encoded bytes, label)`` and ``_num_samples``."""

    def __init__(self, batch_size: int, crop: tuple[int, int] = (224, 224),
                 train: bool = False, short_side: Optional[int] = None,
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None,
                 hflip: Optional[bool] = None,
                 augment: Optional[Callable] = None,
                 seed: int = 0, n_threads: int = 8, window: int = 4,
                 drop_remainder: bool = True):
        self.batch_size = batch_size
        self.crop = tuple(crop)
        self.train = train
        # train default: the standard 256-for-224 headroom ratio so random
        # crops see translation jitter; eval default: scale-to-fill
        self.short_side = (short_side if short_side is not None
                           else (int(round(max(crop) * 8 / 7)) if train
                                 else None))
        self.mean = (np.asarray(mean, np.float32) if mean is not None
                     else np.zeros(3, np.float32))
        self.std = (np.asarray(std, np.float32) if std is not None
                    else np.ones(3, np.float32))
        self.hflip = train if hflip is None else hflip
        self.augment = augment  # optional (uint8 img, rng) -> uint8 img
        self.seed = seed
        self.n_threads = n_threads
        self.window = max(1, window)
        self.drop_remainder = drop_remainder
        self._epoch = 0

    # ---- subclass API
    def _read_raw(self, j: int) -> tuple[bytes, int]:
        raise NotImplementedError

    def _num_samples(self) -> int:
        raise NotImplementedError

    # ---- per-sample path (runs on a worker thread)
    def _load_sample(self, j: int, epoch: int) -> tuple[np.ndarray, int]:
        raw, label = self._read_raw(j)
        img = decode_resize(raw, self.short_side,
                            fill=None if self.short_side else self.crop)
        rng = None
        if self.train:
            # per-(epoch, sample) seed: reproducible independent of which
            # worker thread runs this sample
            mix = (self.seed * 0x9E3779B9 + epoch * 0x85EBCA6B + j) \
                & 0xFFFFFFFF
            rng = np.random.RandomState(mix)
            if self.augment is not None:
                img = self.augment(img, rng)
        x = augment_sample(img, self.crop, self.mean, self.std, rng,
                           self.hflip)
        return x, label

    def __iter__(self) -> Iterator[MiniBatch]:
        n = self._num_samples()
        bs = self.batch_size
        epoch = self._epoch
        if self.train:
            self._epoch += 1
            order = np.random.RandomState(
                (self.seed + epoch) & 0xFFFFFFFF).permutation(n)
        else:
            order = np.arange(n)
        n_batches = n // bs if self.drop_remainder else -(-n // bs)
        cap = getattr(self, "_batch_cap", None)
        if cap is not None:
            n_batches = min(n_batches, cap(bs))
        with ThreadPoolExecutor(max_workers=self.n_threads) as ex:
            pending: deque = deque()

            def submit(bi: int) -> None:
                idx = order[bi * bs:(bi + 1) * bs]
                pending.append([ex.submit(self._load_sample, int(j), epoch)
                                for j in idx])

            for bi in range(min(self.window, n_batches)):
                submit(bi)
            nxt = min(self.window, n_batches)
            for _ in range(n_batches):
                futs = pending.popleft()
                samples = [f.result() for f in futs]
                if nxt < n_batches:
                    submit(nxt)
                    nxt += 1
                x = np.stack([s[0] for s in samples])
                y = np.asarray([s[1] for s in samples], np.int32)
                yield MiniBatch(x, y)

    def size(self) -> int:
        return self._num_samples()

    def shuffle(self, seed=None):
        """Reshuffle happens per epoch from (seed + epoch); an explicit
        seed restarts the schedule."""
        if seed is not None:
            self.seed, self._epoch = seed, 0


class StreamingImageFolder(_StreamingImageBase):
    """Stream ``root/<class>/*.jpg`` with per-sample train augmentation —
    the lazy ImageNet folder path (files are read and decoded per batch;
    nothing is materialized)."""

    def __init__(self, root: str, batch_size: int, **kw):
        from bigdl_tpu_torch.dataset.folder import list_image_folder

        self.paths, self.labels, self.classes = list_image_folder(root)
        super().__init__(batch_size, **kw)

    def _read_raw(self, j: int) -> tuple[bytes, int]:
        with open(self.paths[j], "rb") as f:
            return f.read(), int(self.labels[j])

    def _num_samples(self) -> int:
        return len(self.paths)


class RecordImageDataSet(_StreamingImageBase):
    """Stream image records from sharded record files (the
    SequenceFile-analog ImageNet path, ``dataset/recordfile.py``).

    ``shards``: directory, glob, or explicit list. ``shard=(i, k)``
    restricts to shard files ``i::k`` — per-host partitioning for
    multi-process training (the locality feeding that replaces
    ZippedPartitionsWithLocalityRDD). Partitioned datasets cap their
    batch count at the SMALLEST partition's so every host steps the same
    number of times (unequal counts would deadlock the first collective
    after the shortest host stops — same guarantee as ShardedDataSet).
    """

    def __init__(self, shards, batch_size: int,
                 shard: Optional[tuple[int, int]] = None, **kw):
        all_files = (list(shards) if isinstance(shards, (list, tuple))
                     else rf.list_shards(shards))
        if not all_files:
            raise FileNotFoundError(f"no record shards under {shards!r}")
        counts = dict(zip(all_files, self._count_records(all_files)))
        files = all_files
        if shard is not None:
            i, k = shard
            files = all_files[i::k]
            # every host sees the full shard list, so each can compute the
            # global minimum partition size without communicating
            min_part = min(sum(counts[p] for p in all_files[j::k])
                           for j in range(k))
            self._batch_cap = lambda bs: max(min_part // bs, 0)
        self.shard_files = files
        # global sample id j -> (shard, record) via cumulative counts
        self._cum = np.cumsum([0] + [counts[p] for p in files])
        self._tls = threading.local()  # per-thread reader handles
        super().__init__(batch_size, **kw)

    @staticmethod
    def _count_records(files: list) -> list:
        """Parallel index reads — thousands of shards on network storage
        would otherwise serialize open+seek round-trips at startup."""
        def count(p):
            with rf.RecordReader(p) as r:
                return len(r)
        with ThreadPoolExecutor(max_workers=min(16, len(files))) as ex:
            return list(ex.map(count, files))

    def _reader(self, s: int) -> rf.RecordReader:
        cache = getattr(self._tls, "readers", None)
        if cache is None:
            cache = self._tls.readers = {}
        if s not in cache:
            cache[s] = rf.RecordReader(self.shard_files[s])
        return cache[s]

    def _read_raw(self, j: int) -> tuple[bytes, int]:
        s = int(np.searchsorted(self._cum, j, side="right")) - 1
        label, img = rf.unpack_image_record(
            self._reader(s).read(j - int(self._cum[s])))
        return img, label

    def _num_samples(self) -> int:
        return int(self._cum[-1])
