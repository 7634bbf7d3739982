"""Checkpoint files (counterpart of ``bigdl_tpu/utils/file.py``; reference
utils/File.scala).

A blob is an ``np.savez`` archive of ``leaf_0`` ... ``leaf_{n-1}`` arrays,
then a ``<path>.sha256`` sidecar (its presence implies a whole blob
existed), then a ``<path>.manifest.json`` (the leaves' shapes and dtypes,
in the JAX package's JSON shape), last. A local blob is written to
``<path>.tmp`` and renamed; a ``scheme://`` path (``gs://``, ``s3://``,
``memory://``, ...) goes through fsspec, the blob in one put. The JAX
package stores a pickled jax treedef beside the leaves
(``__treedef__``); the port stores the leaves' key paths as JSON
(``__paths__``) in its place, and reads a JAX blob's leaves by position
(:mod:`bigdl_tpu_torch.interop.checkpoint`).

The snapshot helpers follow the JAX package's: ``model.<n>`` holds params
and module state, ``state.<n>`` the optimizer state; the newest pair whose
blobs and manifests verify is the one to resume from, and the GC never
deletes it. A snapshot may also be a directory written by
:mod:`bigdl_tpu_torch.utils.orbax_ckpt` (``torch.distributed.checkpoint``),
which carries no sidecar and verifies as it is.

Fault sites: :func:`save_leaves` visits ``ckpt_save`` before the write and
calls the ``corrupt`` pass after the manifest; :func:`load_leaves` visits
``ckpt_restore`` (no-ops unless a ``--faultPlan`` is installed), so a
``model.<n>``/``state.<n>`` pair is two visits, as in the JAX package."""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the fault sites of the resilience layer (no-ops unless a plan is
# installed); ChecksumError lives beside the fault that causes it, so the
# supervisor's retryable set and the checkpoint loader share one type
from bigdl_tpu_torch.resilience.faults import (ChecksumError,
                                               hook as _fault_hook,
                                               post_write_hook as
                                               _post_write_hook)

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["ChecksumError", "save_leaves", "load_leaves", "checksum_path",
           "manifest_path", "verify_checkpoint", "read_manifest",
           "verify_manifest", "latest_checkpoint", "latest_checkpoint_pair",
           "latest_valid_checkpoint_pair", "gc_checkpoints",
           "orphaned_snapshots", "is_remote", "exists", "isdir", "join",
           "restore_resharded", "save_module", "load_module",
           "JaxModuleFileError", "is_jax_module_file"]

CHECKSUM_SUFFIX = ".sha256"
MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_VERSION = 1
PATHS_KEY = "__paths__"
TREEDEF_KEY = "__treedef__"
# the leaf of a whole-model file that holds the pickled definition
MODULE_KEY = "__module__"


def is_remote(path: str) -> bool:
    """True for scheme-prefixed (fsspec) paths like ``gs://bucket/dir``."""
    return "://" in str(path)


def _fs_for(path: str):
    import fsspec

    return fsspec.core.url_to_fs(str(path))  # (fs, stripped path)


def exists(path: str) -> bool:
    """Whether ``path`` exists, local or fsspec (the checkpoint overwrite
    guard holds on remote paths too)."""
    if is_remote(path):
        fs, p = _fs_for(path)
        return fs.exists(p)
    return os.path.exists(path)


def isdir(path: str) -> bool:
    """Whether ``path`` is a directory, local or fsspec (a sharded
    snapshot is a directory, a blob a file)."""
    if is_remote(path):
        fs, p = _fs_for(path)
        return fs.isdir(p)
    return os.path.isdir(path)


def join(directory: str, name: str) -> str:
    """``directory/name`` for a local or fsspec directory."""
    if is_remote(directory):
        return f"{str(directory).rstrip('/')}/{name}"
    return os.path.join(directory, name)


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


def _blob_sha256(path: str) -> str:
    if is_remote(path):
        fs, p = _fs_for(path)
        with fs.open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    return _file_sha256(path)


def _write_text(path: str, text: str) -> None:
    """A small file, whole or not at all: tmp + rename locally, one put
    remotely."""
    if is_remote(path):
        fs, p = _fs_for(path)
        with fs.open(p, "w") as f:
            f.write(text)
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _read_text(path: str) -> Optional[str]:
    """The file's text, or None when it does not exist."""
    if is_remote(path):
        fs, p = _fs_for(path)
        if not fs.exists(p):
            return None
        with fs.open(p, "r") as f:
            return f.read()
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return None


def save_leaves(path: str, leaves: Sequence[np.ndarray],
                key_paths: Sequence[Sequence[str]],
                layout: Optional[dict] = None) -> None:
    """Write ``leaves`` (in order) and their key paths to ``path``, then
    its checksum sidecar, then its manifest; ``layout`` is the writer's
    data-parallel layout (``DataParallel.layout_signature()``), recorded
    in the manifest as the JAX package records it."""
    path = str(path)
    _fault_hook("ckpt_save")
    if len(leaves) != len(key_paths):
        raise ValueError(f"{len(leaves)} leaves but {len(key_paths)} paths")
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    meta = np.frombuffer(json.dumps([list(p) for p in key_paths]).encode(),
                         dtype=np.uint8)
    if is_remote(path):
        # object stores take one put: the archive is built in memory
        fs, p = _fs_for(path)
        parent = p.rsplit("/", 1)[0]
        if parent:
            fs.makedirs(parent, exist_ok=True)
        payload = io.BytesIO()
        np.savez(payload, **{PATHS_KEY: meta}, **arrays)
        with fs.open(p, "wb") as f:
            f.write(payload.getbuffer())
        digest = hashlib.sha256(payload.getbuffer()).hexdigest()
    else:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{PATHS_KEY: meta}, **arrays)
        digest = _file_sha256(tmp)
        os.replace(tmp, path)
    _write_text(checksum_path(path), digest)
    doc = {"version": MANIFEST_VERSION, "n_leaves": len(arrays),
           "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                      for a in arrays.values()],
           "layout": layout}
    _write_text(manifest_path(path), json.dumps(doc, sort_keys=True))
    _post_write_hook("ckpt_save", path)


def _read_sidecar(path: str) -> Optional[str]:
    try:
        text = _read_text(checksum_path(path))
    except OSError:
        return None
    return None if text is None else text.strip()


def load_leaves(path: str, verify: bool = True
                ) -> Tuple[List[np.ndarray], Optional[List[Tuple[str, ...]]]]:
    """(leaves in order, key paths) of a blob written by the port or by
    the JAX package; the key paths are None for a JAX blob, whose treedef
    is a pickle of jax objects and is not read. With ``verify`` a blob
    that has a sidecar is digested first and a mismatch raises
    :class:`ChecksumError`."""
    path = str(path)
    _fault_hook("ckpt_restore")
    expected = _read_sidecar(path) if verify else None
    if is_remote(path):
        fs, p = _fs_for(path)
        with fs.open(p, "rb") as f:
            src = io.BytesIO(f.read())
        got = (hashlib.sha256(src.getbuffer()).hexdigest()
               if expected is not None else None)
    else:
        src = path
        got = _file_sha256(path) if expected is not None else None
    if expected is not None and got != expected:
        raise ChecksumError(f"{path}: checksum mismatch with its sidecar "
                            f"(torn write or bit rot)")
    with np.load(src, allow_pickle=False) as z:
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
    without a sidecar, and a sharded snapshot directory, cannot be checked
    and verify True."""
    path = str(path)
    try:
        if isdir(path):
            return True
        expected = _read_sidecar(path)
        return expected is None or _blob_sha256(path) == expected
    except OSError:
        return False


def read_manifest(path: str) -> Optional[dict]:
    """The manifest of blob ``path``, or None when it has none; a manifest
    that does not parse raises :class:`ChecksumError`."""
    mp = manifest_path(str(path))
    try:
        body = _read_text(mp)
    except OSError as e:
        raise ChecksumError(f"{mp}: unreadable manifest: {e}") from None
    if body is None:
        return None
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


def check_manifest(path: str, leaves: Sequence) -> None:
    """Hold ``leaves``, as loaded from blob ``path``, against its manifest
    (when it has one): their count, and each one's shape and dtype. A
    mismatch raises :class:`ChecksumError`."""
    man = read_manifest(path)
    if man is None:
        return
    recs = man.get("leaves") or []
    if man.get("n_leaves") != len(leaves) or len(recs) != len(leaves):
        raise ChecksumError(f"{path}: the manifest records "
                            f"{man.get('n_leaves')} leaves, the blob "
                            f"holds {len(leaves)}")
    for i, (leaf, rec) in enumerate(zip(leaves, recs)):
        if (list(leaf.shape) != list(rec.get("shape", [])) or
                str(leaf.dtype) != rec.get("dtype")):
            raise ChecksumError(
                f"{path}: leaf {i} is {leaf.dtype}{list(leaf.shape)}, "
                f"the manifest says {rec.get('dtype')}{rec.get('shape')}")


def restore_resharded(path: str, mesh, axis: str = "data",
                      zero1: bool = True, verify: bool = True,
                      params: Optional[dict] = None) -> dict:
    """The blob at ``path``, written under any number of ranks, placed for
    this rank of ``mesh`` (``parallel.make_mesh``): ``{key path: CPU
    tensor}``. The leaves are held against the blob's manifest first (a
    mismatch raises :class:`ChecksumError`). Blobs hold whole tensors, so
    resharding is a placement: every rank gets every leaf, except that
    with ``zero1`` and the model's ``params`` ({name: tensor}) each rank
    keeps only the optimizer-state entries of the parameters it owns at
    the mesh's size (``parallel.data_parallel.balanced_owners``, the
    ZeRO-1 rule of :class:`~bigdl_tpu_torch.parallel.DataParallel`)."""
    import torch

    leaves, paths = load_leaves(path, verify=verify)
    check_manifest(path, leaves)
    if paths is None:
        raise ValueError(f"{path}: a JAX blob has no key paths; read it "
                         f"against a model (interop.checkpoint)")
    keep = None
    if zero1 and params is not None and mesh.size > 1:
        from bigdl_tpu_torch.parallel.data_parallel import balanced_owners
        owners = balanced_owners(
            {n: p.numel() * p.element_size() for n, p in params.items()},
            mesh.size)
        keep = lambda kp: owners.get(".".join(kp[1:]),  # noqa: E731
                                     mesh.rank) == mesh.rank
    return {kp: torch.from_numpy(np.array(leaf))
            for kp, leaf in zip(paths, leaves) if keep is None or keep(kp)}


class JaxModuleFileError(ValueError):
    """A whole-model file written by the JAX package: its definition is a
    pickle of ``bigdl_tpu`` classes, which the port does not import. Its
    ``params``/``mod_state`` leaves still load into a rebuilt model
    (``cli.common.load_trained``)."""


def _open_blob(path: str):
    if is_remote(path):
        fs, p = _fs_for(path)
        with fs.open(p, "rb") as f:
            return io.BytesIO(f.read())
    return path


def is_jax_module_file(path: str) -> bool:
    """Whether ``path`` is a JAX blob whose tree has the ``__module__``
    leaf (JAX ``save_module``). The treedef is a pickle of jax objects and
    is not unpickled: its bytes name the tree's keys."""
    try:
        with np.load(_open_blob(str(path)), allow_pickle=False) as z:
            if PATHS_KEY in z.files or TREEDEF_KEY not in z.files:
                return False
            return MODULE_KEY.encode() in z[TREEDEF_KEY].tobytes()
    except (OSError, ValueError):
        return False


def _meta_shell(module):
    """A copy of ``module`` whose parameters and persistent buffers are
    ``meta`` tensors of the same shapes and dtypes (non-persistent buffers,
    which no checkpoint holds, keep their values)."""
    import copy

    import torch

    persistent = {id(t) for t in module.state_dict(keep_vars=True).values()}
    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        if id(t) not in persistent or id(t) in memo:
            continue
        empty = torch.empty_like(t, device="meta")
        memo[id(t)] = (torch.nn.Parameter(empty,
                                          requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else empty)
    return copy.deepcopy(module, memo)


def save_module(module, path: str, layout: Optional[dict] = None) -> None:
    """Whole-model file: the module DEFINITION (pickled with its
    parameters and buffers on the ``meta`` device, so no weight is in the
    pickle) beside its params and module state as the checkpoint leaves,
    under their JAX key paths, in one blob (the reference's
    ``model.save(path)``; JAX ``save_module``), so a predict program needs
    no model-building code. Weights-only interchange stays on
    ``interop.checkpoint.save_model``."""
    import pickle

    from bigdl_tpu_torch.interop.checkpoint import _save, model_tensors

    params, state = model_tensors(module)
    shell = np.frombuffer(pickle.dumps(_meta_shell(module)), dtype=np.uint8)
    _save(path, {"params": params, "mod_state": state, MODULE_KEY: shell},
          module, layout)


def load_module(path: str):
    """The module of a :func:`save_module` file, its weights loaded, on the
    CPU (the caller moves it). Trust note: like the reference's Java
    deserialization, the module definition is a pickle; load only files
    you produced. A file without the definition (a weights-only
    checkpoint) raises ``KeyError``; a JAX whole-model file raises
    :class:`JaxModuleFileError`."""
    import pickle

    from bigdl_tpu_torch.interop.checkpoint import load_model

    path = str(path)
    leaves, paths = load_leaves(path)
    if paths is None:
        if is_jax_module_file(path):
            raise JaxModuleFileError(
                f"{path}: a whole-model file written by the JAX package; "
                f"its module definition is a pickle of bigdl_tpu classes, "
                f"which the PyTorch port does not load (rebuild the model, "
                f"e.g. predict --modelName, and load the file's weights)")
        raise KeyError(MODULE_KEY)
    found = [leaf for kp, leaf in zip(paths, leaves) if kp == (MODULE_KEY,)]
    if not found:
        raise KeyError(MODULE_KEY)
    module = pickle.loads(np.asarray(found[0], np.uint8).tobytes())
    tensors, _ = load_model(path, module)
    module.load_state_dict(tensors, strict=True, assign=True)
    return module


def _names(directory: str) -> Optional[List[str]]:
    """The entry names of a local or fsspec directory, or None when it
    does not exist."""
    directory = str(directory)
    if is_remote(directory):
        fs, d = _fs_for(directory)
        if not fs.isdir(d):
            return None
        return [e.rstrip("/").rsplit("/", 1)[-1]
                for e in fs.ls(d, detail=False)]
    return os.listdir(directory) if os.path.isdir(directory) else None


def _indices(names, prefix: str) -> set:
    out = set()
    for f in names:
        if f.startswith(prefix) and f[len(prefix):].isdigit():
            out.add(int(f[len(prefix):]))
    return out


def latest_checkpoint(directory: str, prefix: str = "model.") -> Optional[str]:
    """The highest-numbered ``<prefix><n>`` in ``directory``, or None."""
    idx = _indices(_names(directory) or (), prefix)
    return join(directory, f"{prefix}{max(idx)}") if idx else None


def latest_checkpoint_pair(directory: str):
    """(model.<n>, state.<n>) of the newest n that has both, else (None,
    None): a kill between the two writes must not pair params of one
    iteration with optimizer state of another."""
    names = _names(directory) or ()
    common = _indices(names, "model.") & _indices(names, "state.")
    if not common:
        return None, None
    n = max(common)
    return join(directory, f"model.{n}"), join(directory, f"state.{n}")


def latest_valid_checkpoint_pair(directory: str):
    """The newest (model.<n>, state.<n>) whose blobs and manifests verify,
    else (None, None); newer pairs that fail are skipped with a
    warning."""
    names = _names(directory) or ()
    common = _indices(names, "model.") & _indices(names, "state.")
    for n in sorted(common, reverse=True):
        m = join(directory, f"model.{n}")
        s = join(directory, f"state.{n}")
        if all(verify_checkpoint(p) and verify_manifest(p) for p in (m, s)):
            return m, s
        logger.warning("checkpoint pair %d in %s fails checksum or "
                       "manifest verification: falling back to the "
                       "previous snapshot", n, directory)
    return None, None


def _remove(path: str) -> bool:
    """Delete a file or directory, local or fsspec; False if absent."""
    if is_remote(path):
        fs, p = _fs_for(path)
        if not fs.exists(p):
            return False
        fs.rm(p, recursive=True)
        return True
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
    else:
        return False
    return True


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
        keep.add(int(m_valid.rstrip("/").rsplit(".", 1)[-1]))
    deleted = []
    for n in sorted(every - keep):
        for prefix in prefixes:
            if n not in _indices(names, prefix):
                continue
            base = join(directory, f"{prefix}{n}")
            for path in (base, checksum_path(base), manifest_path(base)):
                try:
                    if _remove(path):
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
                out.append(join(directory, f))
    return out
