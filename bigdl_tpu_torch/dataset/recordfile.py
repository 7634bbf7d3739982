"""Sharded record files (counterpart of ``bigdl_tpu/dataset/recordfile.py``,
byte for byte the same format, so either package reads the other's
shards).

The reference ingests ImageNet as 512-image Hadoop SequenceFiles
(dataset/DataSet.scala:384-455, generator
models/utils/ImageNetSeqFileGenerator.scala): millions of small JPEGs
become a few thousand large sequential files. Shard layout
(``<prefix>-00000-of-00042.btr``)::

    [8B magic "BTRECv1\\n"]
    [record]*          record = [uint32 payload_len][payload bytes]
    [index]            uint64 file-offset of each record (count entries)
    [trailer]          [uint64 index_offset][uint64 count][8B magic]

The embedded index makes every record randomly addressable (seek + one
read), so a global shuffle is a permutation over (shard, record) pairs.
Image records carry ``[int32 label][encoded image bytes]`` (the original
JPEG/PNG bytes, not re-encoded). The decode/augment hot path lives in
``bigdl_tpu_torch.dataset.streaming``.
"""

from __future__ import annotations

import glob
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

__all__ = [
    "RecordWriter", "RecordReader", "pack_image_record",
    "unpack_image_record", "write_image_shards", "list_shards",
]

MAGIC = b"BTRECv1\n"
_TRAILER = struct.Struct("<QQ8s")  # index_offset, count, magic
_LEN = struct.Struct("<I")


class RecordWriter:
    """Append-only shard writer with an embedded index.

    >>> with RecordWriter(path) as w:
    ...     w.write(b"payload")
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offsets: list[int] = []

    def write(self, payload: bytes) -> int:
        """Append one record; returns its index within the shard."""
        self._offsets.append(self._f.tell())
        self._f.write(_LEN.pack(len(payload)))
        self._f.write(payload)
        return len(self._offsets) - 1

    def close(self) -> None:
        if self._f is None:
            return
        index_offset = self._f.tell()
        if self._offsets:
            self._f.write(np.asarray(self._offsets, "<u8").tobytes())
        self._f.write(_TRAILER.pack(index_offset, len(self._offsets), MAGIC))
        self._f.close()
        self._f = None

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self._offsets)


class RecordReader:
    """Random-access shard reader. Thread-compat: use one reader per
    thread (each holds its own file handle; offsets array is shared-safe).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._f.seek(0, os.SEEK_END)
        end = self._f.tell()
        if end < len(MAGIC) + _TRAILER.size:
            raise IOError(f"{path}: truncated record file")
        self._f.seek(end - _TRAILER.size)
        index_offset, count, magic = _TRAILER.unpack(
            self._f.read(_TRAILER.size))
        if magic != MAGIC:
            raise IOError(f"{path}: bad trailer magic {magic!r}")
        self._f.seek(0)
        if self._f.read(len(MAGIC)) != MAGIC:
            raise IOError(f"{path}: bad header magic")
        self._f.seek(index_offset)
        self.offsets = np.frombuffer(
            self._f.read(8 * count), dtype="<u8")
        if len(self.offsets) != count:
            raise IOError(f"{path}: truncated index")

    def __len__(self) -> int:
        return len(self.offsets)

    def read(self, i: int) -> bytes:
        """Random-access read of record ``i`` (seek + two reads)."""
        self._f.seek(int(self.offsets[i]))
        (n,) = _LEN.unpack(self._f.read(_LEN.size))
        return self._f.read(n)

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self.read(i)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "RecordReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------ image records

_IMG_HDR = struct.Struct("<i")  # label


def pack_image_record(label: int, img_bytes: bytes) -> bytes:
    """[int32 label][encoded image bytes] (the reference's SeqFile value is
    label + raw bytes too, dataset/DataSet.scala:437-447)."""
    return _IMG_HDR.pack(label) + img_bytes


def unpack_image_record(payload: bytes) -> tuple[int, bytes]:
    (label,) = _IMG_HDR.unpack(payload[:_IMG_HDR.size])
    return label, payload[_IMG_HDR.size:]


def list_shards(path_or_glob: str) -> list[str]:
    """Expand a directory, glob, or single file into a sorted shard list."""
    if os.path.isdir(path_or_glob):
        return sorted(glob.glob(os.path.join(path_or_glob, "*.btr")))
    if any(ch in path_or_glob for ch in "*?["):
        return sorted(glob.glob(path_or_glob))
    return [path_or_glob]


def write_image_shards(root: str, out_dir: str, prefix: str = "imagenet",
                       images_per_shard: int = 512, workers: int = 8,
                       limit: Optional[int] = None) -> list[str]:
    """Convert a label-by-folder image tree into record shards (the
    ImageNetSeqFileGenerator analog: parallel workers, N images per shard,
    label packed with the bytes). Returns the shard paths.

    Class ids follow sorted folder names — identical to
    ``list_image_folder`` so folder- and record-trained models agree.
    """
    from bigdl_tpu_torch.dataset.folder import list_image_folder

    paths, labels, classes = list_image_folder(root)
    if limit is not None:
        paths, labels = paths[:limit], labels[:limit]
    os.makedirs(out_dir, exist_ok=True)
    n = len(paths)
    n_shards = max(1, (n + images_per_shard - 1) // images_per_shard)

    def write_shard(s: int) -> str:
        shard_path = os.path.join(
            out_dir, f"{prefix}-{s:05d}-of-{n_shards:05d}.btr")
        lo, hi = s * images_per_shard, min(n, (s + 1) * images_per_shard)
        with RecordWriter(shard_path) as w:
            for i in range(lo, hi):
                with open(paths[i], "rb") as f:
                    w.write(pack_image_record(int(labels[i]), f.read()))
        return shard_path

    with ThreadPoolExecutor(max_workers=workers) as ex:
        shards = list(ex.map(write_shard, range(n_shards)))
    # class-name manifest so readers can map ids back to folder names
    with open(os.path.join(out_dir, f"{prefix}.classes.txt"), "w") as f:
        f.write("\n".join(classes))
    return shards
