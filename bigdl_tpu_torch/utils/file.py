"""Checkpoint files on local paths (counterpart of
``bigdl_tpu/utils/file.py``; reference utils/File.scala).

A blob is an ``np.savez`` archive of ``leaf_0`` ... ``leaf_{n-1}`` arrays,
written to ``<path>.tmp`` and renamed, then a ``<path>.sha256`` sidecar
(its presence implies a whole blob existed), then a
``<path>.manifest.json`` (the leaves' shapes and dtypes, in the JAX
package's JSON shape), last. The JAX package stores a pickled jax treedef
beside the leaves (``__treedef__``); the port stores the leaves' key
paths as JSON (``__paths__``) in its place, and reads a JAX blob's leaves
by position (:mod:`bigdl_tpu_torch.interop.checkpoint`).

The snapshot helpers follow the JAX package's: ``model.<n>`` holds params
and module state, ``state.<n>`` the optimizer state; the newest pair whose
blobs and manifests verify is the one to resume from, and the GC never
deletes it. Remote (``scheme://``) paths and orbax's sharded directories
are not ported (ROADMAP.md queue 1 item 13) and raise."""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np

# defined beside the fault that causes it, so the supervisor's retryable
# set and the checkpoint loader share one type
from bigdl_tpu_torch.resilience.faults import ChecksumError

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["ChecksumError", "save_leaves", "load_leaves", "checksum_path",
           "manifest_path", "verify_checkpoint", "read_manifest",
           "verify_manifest", "latest_checkpoint", "latest_checkpoint_pair",
           "latest_valid_checkpoint_pair", "gc_checkpoints",
           "orphaned_snapshots"]

CHECKSUM_SUFFIX = ".sha256"
MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_VERSION = 1
PATHS_KEY = "__paths__"
TREEDEF_KEY = "__treedef__"


def _local(path: str) -> str:
    path = str(path)
    if "://" in path:
        raise NotImplementedError(
            f"{path}: remote checkpoint paths are not in the PyTorch port "
            f"yet (ROADMAP.md queue 1 item 13); use a local path")
    return path


def checksum_path(path: str) -> str:
    return path + CHECKSUM_SUFFIX


def manifest_path(path: str) -> str:
    return path + MANIFEST_SUFFIX


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_atomic(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def save_leaves(path: str, leaves: Sequence[np.ndarray],
                key_paths: Sequence[Sequence[str]],
                layout: Optional[dict] = None) -> None:
    """Write ``leaves`` (in order) and their key paths to ``path``, then
    its checksum sidecar, then its manifest; ``layout`` is the writer's
    data-parallel layout (``DataParallel.layout_signature()``), recorded
    in the manifest as the JAX package records it."""
    path = _local(path)
    if len(leaves) != len(key_paths):
        raise ValueError(f"{len(leaves)} leaves but {len(key_paths)} paths")
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    meta = np.frombuffer(json.dumps([list(p) for p in key_paths]).encode(),
                         dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{PATHS_KEY: meta}, **arrays)
    digest = _file_sha256(tmp)
    os.replace(tmp, path)
    _write_atomic(checksum_path(path), digest)
    doc = {"version": MANIFEST_VERSION, "n_leaves": len(arrays),
           "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                      for a in arrays.values()],
           "layout": layout}
    _write_atomic(manifest_path(path), json.dumps(doc, sort_keys=True))


def _read_sidecar(path: str) -> Optional[str]:
    try:
        with open(checksum_path(path)) as f:
            return f.read().strip()
    except FileNotFoundError:
        return None


def load_leaves(path: str, verify: bool = True
                ) -> Tuple[List[np.ndarray], Optional[List[Tuple[str, ...]]]]:
    """(leaves in order, key paths) of a blob written by the port or by
    the JAX package; the key paths are None for a JAX blob, whose treedef
    is a pickle of jax objects and is not read. With ``verify`` a blob
    that has a sidecar is digested first and a mismatch raises
    :class:`ChecksumError`."""
    path = _local(path)
    expected = _read_sidecar(path) if verify else None
    if expected is not None and _file_sha256(path) != expected:
        raise ChecksumError(f"{path}: checksum mismatch with its sidecar "
                            f"(torn write or bit rot)")
    with np.load(path, allow_pickle=False) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        paths = None
        if PATHS_KEY in z.files:
            paths = [tuple(p) for p in json.loads(z[PATHS_KEY].tobytes())]
        elif TREEDEF_KEY not in z.files:
            raise ValueError(f"{path}: neither {PATHS_KEY} nor "
                             f"{TREEDEF_KEY}: not a checkpoint blob")
    return leaves, paths


def verify_checkpoint(path: str) -> bool:
    """True when ``path``'s sidecar (if any) matches the blob; a blob
    without a sidecar cannot be checked and verifies True."""
    path = _local(path)
    try:
        expected = _read_sidecar(path)
        return expected is None or _file_sha256(path) == expected
    except OSError:
        return False


def read_manifest(path: str) -> Optional[dict]:
    """The manifest of blob ``path``, or None when it has none; a manifest
    that does not parse raises :class:`ChecksumError`."""
    mp = manifest_path(_local(path))
    try:
        with open(mp) as f:
            body = f.read()
    except FileNotFoundError:
        return None
    except OSError as e:
        raise ChecksumError(f"{mp}: unreadable manifest: {e}") from None
    try:
        doc = json.loads(body)
        if not isinstance(doc, dict) or "version" not in doc:
            raise ValueError("not a manifest document")
    except ValueError as e:
        raise ChecksumError(f"{mp}: torn or corrupt manifest ({e})") from None
    return doc


def verify_manifest(path: str) -> bool:
    """True when blob ``path``'s manifest is absent or parses."""
    try:
        read_manifest(path)
        return True
    except ChecksumError:
        return False


def _names(directory: str) -> Optional[List[str]]:
    directory = _local(directory)
    return os.listdir(directory) if os.path.isdir(directory) else None


def _indices(names, prefix: str) -> set:
    out = set()
    for f in names:
        if f.startswith(prefix) and f[len(prefix):].isdigit():
            out.add(int(f[len(prefix):]))
    return out


def latest_checkpoint(directory: str, prefix: str = "model.") -> Optional[str]:
    """The highest-numbered ``<prefix><n>`` in ``directory``, or None."""
    names = _names(directory)
    idx = _indices(names or (), prefix)
    return os.path.join(directory, f"{prefix}{max(idx)}") if idx else None


def latest_checkpoint_pair(directory: str):
    """(model.<n>, state.<n>) of the newest n that has both, else (None,
    None): a kill between the two writes must not pair params of one
    iteration with optimizer state of another."""
    names = _names(directory) or ()
    common = _indices(names, "model.") & _indices(names, "state.")
    if not common:
        return None, None
    n = max(common)
    return (os.path.join(directory, f"model.{n}"),
            os.path.join(directory, f"state.{n}"))


def latest_valid_checkpoint_pair(directory: str):
    """The newest (model.<n>, state.<n>) whose blobs and manifests verify,
    else (None, None); newer pairs that fail are skipped with a
    warning."""
    names = _names(directory) or ()
    common = _indices(names, "model.") & _indices(names, "state.")
    for n in sorted(common, reverse=True):
        m = os.path.join(directory, f"model.{n}")
        s = os.path.join(directory, f"state.{n}")
        if all(verify_checkpoint(p) and verify_manifest(p) for p in (m, s)):
            return m, s
        logger.warning("checkpoint pair %d in %s fails checksum or "
                       "manifest verification: falling back to the "
                       "previous snapshot", n, directory)
    return None, None


def gc_checkpoints(directory: str, keep_last: int,
                   prefixes=("model.", "state.")) -> List[str]:
    """Delete all but the newest ``keep_last`` snapshot iterations (blob,
    sidecar and manifest). The newest valid pair is kept even when newer
    corrupt snapshots push it out of the window. Returns what it
    deleted."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    names = _names(directory)
    if names is None:
        return []
    every = set()
    for prefix in prefixes:
        every |= _indices(names, prefix)
    keep = set(sorted(every, reverse=True)[:keep_last])
    m_valid, _ = latest_valid_checkpoint_pair(directory)
    if m_valid is not None:
        keep.add(int(m_valid.rsplit(".", 1)[-1]))
    deleted = []
    for n in sorted(every - keep):
        for prefix in prefixes:
            if n not in _indices(names, prefix):
                continue
            base = os.path.join(directory, f"{prefix}{n}")
            for path in (base, checksum_path(base), manifest_path(base)):
                try:
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    elif os.path.exists(path):
                        os.remove(path)
                    else:
                        continue
                    deleted.append(path)
                except OSError as e:
                    logger.warning("checkpoint GC: could not delete %s: %s",
                                   path, e)
    if deleted:
        logger.info("checkpoint GC: removed %d artifact(s), kept "
                    "iterations %s", len(deleted), sorted(keep))
    return deleted


def orphaned_snapshots(directory: str, newer_than: int) -> List[str]:
    """``model.<n>``/``state.<n>`` paths with n > ``newer_than``: after an
    unclean stop these are unmatched, and a resumed run that goes on past
    ``newer_than`` will write exactly these names."""
    out = []
    for f in _names(directory) or ():
        for prefix in ("model.", "state."):
            tail = f[len(prefix):]
            if f.startswith(prefix) and tail.isdigit() and \
                    int(tail) > newer_than:
                out.append(os.path.join(directory, f))
    return out
