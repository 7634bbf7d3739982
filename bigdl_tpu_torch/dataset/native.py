"""ctypes bindings for the port's native C++ input pipeline
(``bigdl_tpu_torch/native/bigdl_native.cpp``; counterpart of
``bigdl_tpu/dataset/native.py``): the multi-threaded crop/flip/normalize
path of the reference (image/MTLabeledBGRImgToBatch.scala:48-133), libjpeg
decode, and the raw MNIST idx and CIFAR-10 readers.

The library is built from that one source with ``g++`` at first use, into
``build/native/`` at the root of the checkout (git-ignored), named after a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is built once. The build links libjpeg where it links
(``-DBT_WITH_JPEG -ljpeg``) and builds without it otherwise, as the JAX
package's Makefile does; :func:`jpeg_available` says which flavour loaded.
A file lock and an atomic rename keep concurrent builders (test workers,
several processes of one checkout) from loading a half-written library.
Nothing is built when this module is imported.

A library that cannot be built or loaded makes :func:`available` False and
every entry point that needs it raise with the compiler's or the loader's
message; nothing falls back to unaugmented batches in its place.
``NativePrefetchDataSet`` feeds the ``DataSet`` protocol the Optimizer
consumes: worker threads (GIL released) crop, flip and normalise raw
uint8 samples while the card runs the previous step.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import DataSet, MiniBatch

__all__ = ["available", "load_error", "jpeg_available", "library_path",
           "decode_jpeg", "augment_sample_native", "NativePrefetchDataSet",
           "read_idx", "read_cifar10"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "bigdl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-shared")

_lock = threading.Lock()  # streaming workers probe concurrently
_state: dict = {"lib": None, "error": None, "path": None, "tried": False}


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libbigdl_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the source into ``out`` (with libjpeg where it links) under
    a file lock; raises RuntimeError with the compiler's output."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        logs = []
        for extra, libs in ((["-DBT_WITH_JPEG"], ["-ljpeg"]), ([], [])):
            proc = subprocess.run(
                [cxx, *CXXFLAGS, *extra, "-o", str(tmp), str(SOURCE), *libs],
                capture_output=True, text=True, timeout=300)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return
            logs.append(proc.stdout + proc.stderr)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           + "\n".join(logs))


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                out = _target()
                if not out.exists():
                    _build(out)
                lib = ctypes.CDLL(str(out))
                _bind(lib)
                _state["lib"], _state["path"] = lib, str(out)
            except (OSError, RuntimeError, AttributeError,
                    subprocess.SubprocessError) as e:
                _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: "
                           f"{_state['error']}")
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    create = [vp, i64, i32, i32, i32, vp, i32, i32, i32, i32, i32, vp, vp,
              i32, i32, ctypes.c_uint64, i32, i32]
    lib.bt_pipeline_create_at.restype = vp
    lib.bt_pipeline_create_at.argtypes = create + [ctypes.c_long]
    lib.bt_pipeline_next.restype = ctypes.c_long
    lib.bt_pipeline_next.argtypes = [vp, vp, vp]
    lib.bt_pipeline_destroy.restype = None
    lib.bt_pipeline_destroy.argtypes = [vp]
    lib.bt_read_idx.restype = i64
    lib.bt_read_idx.argtypes = [ctypes.c_char_p, ctypes.POINTER(vp),
                                ctypes.POINTER(i64), ctypes.POINTER(i32)]
    lib.bt_read_cifar10.restype = i64
    lib.bt_read_cifar10.argtypes = [ctypes.c_char_p, vp, vp, i64]
    lib.bt_free.restype = None
    lib.bt_free.argtypes = [vp]
    lib.bt_augment_sample.restype = i32
    lib.bt_augment_sample.argtypes = [vp, i32, i32, i32, vp, i32, i32, i32,
                                      i32, i32, vp, vp]
    lib.bt_jpeg_available.restype = i32
    lib.bt_jpeg_available.argtypes = []
    lib.bt_decode_jpeg.restype = i32
    lib.bt_decode_jpeg.argtypes = [ctypes.c_char_p, i64, i32, i32, i32,
                                   ctypes.POINTER(vp), ctypes.POINTER(i32),
                                   ctypes.POINTER(i32)]


def available() -> bool:
    """True when the native library loads (it is built on the first
    call)."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not build or load (None if it did or was not
    tried yet)."""
    _load()
    return _state["error"]


def library_path() -> Optional[str]:
    """The loaded library's file."""
    _load()
    return _state["path"]


def jpeg_available() -> bool:
    """True when the loaded library was built against libjpeg."""
    lib = _load()
    return bool(lib is not None and lib.bt_jpeg_available())


def augment_sample_native(img: np.ndarray, out: np.ndarray, off_h: int,
                          off_w: int, flip: bool, mean: np.ndarray,
                          std: np.ndarray) -> None:
    """One-pass crop + flip + normalise (C ``bt_augment_sample``, the GIL
    released during the call). ``img``: contiguous uint8 (H, W, C);
    ``out``: contiguous float32 (ch, cw, C)."""
    lib = _need()
    if img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError("img must be a C-contiguous uint8 array")
    if (out.dtype != np.float32 or not out.flags.c_contiguous
            or out.shape[2] != img.shape[2]):
        raise ValueError("out must be a C-contiguous float32 array with "
                         "the image's channels")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.size != img.shape[2] or std.size != img.shape[2]:
        raise ValueError(f"mean/std need {img.shape[2]} channels")
    ok = lib.bt_augment_sample(
        img.ctypes.data_as(ctypes.c_void_p), img.shape[0], img.shape[1],
        img.shape[2], out.ctypes.data_as(ctypes.c_void_p), out.shape[0],
        out.shape[1], off_h, off_w, int(flip),
        mean.ctypes.data_as(ctypes.c_void_p),
        std.ctypes.data_as(ctypes.c_void_p))
    if not ok:
        raise ValueError(
            f"crop {out.shape[:2]} at offset ({off_h}, {off_w}) falls "
            f"outside source image {img.shape[:2]}: is short_side smaller "
            f"than the crop?")


def decode_jpeg(raw: bytes, short_side: Optional[int] = None,
                fill: Optional[tuple] = None) -> Optional[np.ndarray]:
    """Native JPEG decode and resize (libjpeg DCT scaling, then bilinear to
    the exact target: the C twin of ``streaming.decode_resize``). Returns
    RGB uint8 (H, W, 3), or None where the native path cannot serve this
    input (no libjpeg in the build, or a decode error): the caller then
    decodes with PIL."""
    if not jpeg_available():
        return None
    lib = _load()
    if short_side is not None:
        mode, th, tw = 0, int(short_side), 0
    else:
        mode, (th, tw) = 1, (int(fill[0]), int(fill[1]))
    out = ctypes.c_void_p()
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib.bt_decode_jpeg(raw, len(raw), mode, th, tw, ctypes.byref(out),
                            ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        return None
    try:
        n = oh.value * ow.value * 3
        img = np.frombuffer(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8 * n)).contents,
            dtype=np.uint8).reshape(oh.value, ow.value, 3).copy()
    finally:
        lib.bt_free(out)
    return img


class NativePrefetchDataSet(DataSet):
    """Batches from the C++ worker pool over in-memory uint8 images.

    ``images``: uint8 [n, h, w, c] (or [n, h, w]); ``labels``: int [n].
    ``crop`` crops to (crop_h, crop_w), random when training and centred
    otherwise (the whole image when None); ``mean``/``std`` are per
    channel, applied as ``(x - mean) / std`` to raw 0-255 values. An
    iteration yields ``batches_per_epoch`` = n // batch_size MiniBatches
    of float32 NHWC images and int32 labels, each in its own arrays.

    Where CUDA is available the batch arrays are pinned torch tensors
    from PyTorch's pinned-memory cache (recycled, so the C++ queue copies
    into memory that is already mapped, and the copy to the card needs
    no staging copy first); elsewhere numpy arrays, as in the JAX package.

    ``train=True``: one endless pipeline, reshuffled every epoch from
    ``seed``, prefetching across the epoch boundary; batch t of the stream
    takes its crops and flips from a generator seeded with (seed, t), so
    the stream does not depend on ``n_threads``. An iteration continues
    the stream where the last one stopped (as in the JAX package), but
    never starts before epoch e's first batch, e the number of
    ``shuffle()`` calls: so an Optimizer that resumes at epoch e (it calls
    ``shuffle()`` once per finished epoch) gets the batches of an
    uninterrupted run. ``train=False``: a fresh one-epoch pipeline per
    iteration, in order.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, crop: Optional[tuple] = None,
                 train: bool = False, hflip: Optional[bool] = None,
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 n_threads: int = 4, queue_cap: int = 8):
        self._lib = _need()
        images = np.ascontiguousarray(images, dtype=np.uint8)
        if images.ndim == 3:
            images = images[..., None]
        n, h, w, c = images.shape
        labels = np.ascontiguousarray(labels, dtype=np.int32)
        if len(labels) != n:
            raise ValueError(f"{n} images but {len(labels)} labels")
        self._images, self._labels = images, labels  # borrowed by C++
        self.crop_h, self.crop_w = crop if crop is not None else (h, w)
        if not (0 < self.crop_h <= h and 0 < self.crop_w <= w):
            raise ValueError(f"crop {(self.crop_h, self.crop_w)} does not "
                             f"fit images of {(h, w)}")
        if not 0 < batch_size <= n:
            raise ValueError(f"batch_size {batch_size} for {n} images")
        self.batch_size, self.channels = batch_size, c
        self._mean = (np.asarray(mean, np.float32) if mean is not None
                      else np.zeros(c, np.float32))
        self._std = (np.asarray(std, np.float32) if std is not None
                     else np.ones(c, np.float32))
        if self._mean.size != c or self._std.size != c:
            raise ValueError(f"mean/std need {c} channels")
        self._shuffle = train if shuffle is None else shuffle
        self._hflip = train if hflip is None else hflip
        self._train = train
        self._seed = seed
        self._n_threads, self._queue_cap = n_threads, queue_cap
        self.batches_per_epoch = n // batch_size
        self._epoch = 0   # shuffle() calls
        self._cursor = 0  # the next ticket the endless pipeline delivers
        self._handle = self._create(loop=True, first=0) if train else None

    def _create(self, loop: bool, first: int):
        h, w = self._images.shape[1:3]
        handle = self._lib.bt_pipeline_create_at(
            self._images.ctypes.data_as(ctypes.c_void_p), len(self._images),
            h, w, self.channels,
            self._labels.ctypes.data_as(ctypes.c_void_p), self.batch_size,
            self.crop_h, self.crop_w, int(self._train), int(self._hflip),
            self._mean.ctypes.data_as(ctypes.c_void_p),
            self._std.ctypes.data_as(ctypes.c_void_p), int(self._shuffle),
            int(loop), self._seed, self._n_threads, self._queue_cap, first)
        if not handle:
            raise ValueError("bt_pipeline_create_at refused the pipeline's "
                             "shapes")
        return handle

    def __iter__(self):
        if self._train:
            start = max(self._cursor, self._epoch * self.batches_per_epoch)
            if start != self._cursor:  # a resumed run: restart there
                self._lib.bt_pipeline_destroy(self._handle)
                self._handle = self._create(loop=True, first=start)
                self._cursor = start
            handle = self._handle
        else:
            handle = self._create(loop=False, first=0)
        shape = (self.batch_size, self.crop_h, self.crop_w, self.channels)
        pinned = torch.cuda.is_available()
        try:
            for _ in range(self.batches_per_epoch):
                if pinned:
                    img = torch.empty(shape, dtype=torch.float32,
                                      pin_memory=True)
                    lab = torch.empty(self.batch_size, dtype=torch.int32,
                                      pin_memory=True)
                    ptrs = img.data_ptr(), lab.data_ptr()
                else:
                    img = np.empty(shape, np.float32)
                    lab = np.empty(self.batch_size, np.int32)
                    ptrs = img.ctypes.data, lab.ctypes.data
                t = self._lib.bt_pipeline_next(handle, *ptrs)
                if t < 0:
                    return
                if self._train:
                    self._cursor = t + 1
                yield MiniBatch(img, lab)
        finally:
            if not self._train:
                self._lib.bt_pipeline_destroy(handle)

    def size(self) -> int:
        return len(self._images)

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Count a finished epoch (the C++ side reshuffles each epoch from
        the constructor's seed; ``seed`` is ignored, as in the JAX
        package)."""
        self._epoch += 1

    def skip_epoch(self) -> None:
        self._epoch += 1

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.bt_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def read_idx(path: str) -> np.ndarray:
    """An MNIST idx/ubyte file (``.gz`` decompressed first) through the
    native reader."""
    lib = _need()
    if path.endswith(".gz"):
        import gzip
        import tempfile
        with gzip.open(path, "rb") as f:
            raw = f.read()
        with tempfile.NamedTemporaryFile(suffix=".idx") as tmp:
            tmp.write(raw)
            tmp.flush()
            return read_idx(tmp.name)
    out = ctypes.c_void_p()
    dims = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    total = lib.bt_read_idx(path.encode(), ctypes.byref(out), dims,
                            ctypes.byref(ndim))
    if total < 0:
        raise IOError(f"failed to read idx file {path!r}")
    try:
        shape = tuple(dims[i] for i in range(ndim.value))
        buf = ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8 * total))
        arr = np.frombuffer(buf.contents, dtype=np.uint8).reshape(shape).copy()
    finally:
        lib.bt_free(out)
    return arr


def read_cifar10(paths: Sequence[str]) -> tuple:
    """CIFAR-10 .bin shards through the native reader: NHWC uint8 images
    and int32 labels (at most 10000 records a shard, as in the JAX
    package)."""
    lib = _need()
    per_shard = 10000
    images = np.empty((per_shard * len(paths), 32, 32, 3), np.uint8)
    labels = np.empty(per_shard * len(paths), np.int32)
    count = 0
    for p in paths:
        got = lib.bt_read_cifar10(
            p.encode(), images[count:].ctypes.data_as(ctypes.c_void_p),
            labels[count:].ctypes.data_as(ctypes.c_void_p),
            len(images) - count)
        if got < 0:
            raise IOError(f"failed to read cifar bin {p!r}")
        count += got
    return images[:count], labels[:count]
