"""Sharded checkpoints (counterpart of ``bigdl_tpu/utils/orbax_ckpt.py``):
the multi-rank path, on ``torch.distributed.checkpoint`` (DCP).

The single-blob path gathers the whole state to rank 0, which writes one
``np.savez`` archive (``utils/file.py``). Here every rank of the data
axis takes part in one DCP save of the same tree: DCP's planner gives each
tensor to one rank to write (the tree is whole on every rank, so the
writes spread over the ranks instead of funnelling through rank 0), and
the snapshot is a directory of per-rank ``.distcp`` files plus a
``.metadata`` index, under the two-artifact names ``model.<n>`` and
``state.<n>``. A restore reads every entry at any world size. This module
is opt-in through ``Optimizer.set_checkpoint(..., sharded=True)`` or
direct calls.

A tree is a nested dict of tensors or numpy arrays (a string leaf, as the
executor plan's ``mode``, is kept as a string); DCP sees it flat, its key
paths joined by ``/``. A ``scheme://`` path goes through DCP's fsspec
writer and reader.

Stated differences from the JAX package: the format is DCP where the JAX
package writes orbax, so a JAX orbax directory is refused (with a message
naming the format) and no orbax data is read; remote paths go through
fsspec where orbax uses ``etils.epath``."""

from __future__ import annotations

import os
import warnings
from typing import Any, Optional

import numpy as np

from bigdl_tpu_torch.utils.file import is_remote
from bigdl_tpu_torch.utils.file import latest_checkpoint as latest_sharded  # noqa: F401
# DCP snapshots are directories, but the <prefix><n> selection is the
# single-blob one: one helper serves both

__all__ = ["save_sharded", "restore_sharded", "latest_sharded",
           "restore_for_inference", "is_sharded", "SEP"]

SEP = "/"  # DCP's flat keys are the key paths joined by this
METADATA = ".metadata"  # the DCP index every snapshot directory holds
# files that mark a JAX orbax checkpoint directory
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
                  "_sharding", "checkpoint")


def _dcp():
    import torch.distributed.checkpoint as dcp
    return dcp


def _fs(path: str):
    from bigdl_tpu_torch.utils.file import _fs_for
    return _fs_for(path)


def _writer(path: str):
    if is_remote(path):
        from torch.distributed.checkpoint._fsspec_filesystem import \
            FsspecWriter
        return FsspecWriter(path)
    return _dcp().FileSystemWriter(path)


def _reader(path: str):
    if is_remote(path):
        from torch.distributed.checkpoint._fsspec_filesystem import \
            FsspecReader
        return FsspecReader(path)
    return _dcp().FileSystemReader(path)


def _group():
    """(process group of the job's live ranks, whether one is in use):
    every rank of the current mesh takes part in a save or a restore (a
    tensor-parallel or fully sharded job's too: its trees are whole on
    every rank, gathered before the write)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return None, False
    from bigdl_tpu_torch.parallel.mesh import live_group
    return live_group(), True


def _listdir(path: str) -> list:
    if is_remote(path):
        fs, p = _fs(path)
        return [e.rstrip("/").rsplit("/", 1)[-1]
                for e in fs.ls(p, detail=False)]
    return os.listdir(path)


def is_sharded(path: str) -> bool:
    """Whether the directory ``path`` is a DCP snapshot (it holds
    ``.metadata``). A JAX orbax directory raises ``ValueError`` naming its
    format; any other directory is not a snapshot."""
    names = _listdir(path)
    if METADATA in names:
        return True
    if any(m in names for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path}: a JAX orbax checkpoint directory; the PyTorch port "
            f"reads sharded snapshots written by torch.distributed."
            f"checkpoint (DCP), not orbax: convert it with the JAX package "
            f"(restore it and save_pytree a single blob)")
    return False


def _leaf(v):
    """A leaf as DCP takes it: a tensor, or a string (kept as bytes)."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach()
    a = np.asarray(v)
    return str(a) if a.dtype.kind in "US" else torch.from_numpy(np.array(a))


def _flatten(tree: dict, prefix=()) -> dict:
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        kp = prefix + (str(k),)
        if isinstance(v, dict):
            out.update(_flatten(v, kp))
        else:
            out[kp] = _leaf(v)
    return out


def _flat_keys(flat: dict) -> dict:
    """DCP's flat keys: the key paths joined by ``SEP``."""
    for kp in flat:
        if any(SEP in k for k in kp):
            raise ValueError(f"key path {kp} holds {SEP!r}, the separator")
    return {SEP.join(kp): v for kp, v in flat.items()}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save_sharded(tree: Any, path: str, overwrite: bool = False) -> None:
    """Write ``tree`` as a DCP snapshot directory at ``path``; every rank
    of the data axis calls this with the same whole tree. An existing
    ``path`` raises ``FileExistsError`` unless ``overwrite``, and is
    cleared by rank 0 alone, between two barriers, so ranks never race
    on the directory."""
    _save_flat(_flatten(tree), path, overwrite)


def _save_flat(flat: dict, path: str, overwrite: bool) -> None:
    import torch.distributed as dist

    from bigdl_tpu_torch.utils.file import _remove, exists

    path = str(path) if is_remote(path) else os.path.abspath(path)
    group, dist_on = _group()

    def barrier():
        if dist_on:
            dist.barrier(group=group)

    def is_first():
        return not dist_on or dist.get_rank(group) == 0

    # every rank looks before the first barrier (nothing is written before
    # the second), so on a shared directory all refuse alike
    if exists(path) and not overwrite:
        raise FileExistsError(path)
    barrier()
    if is_first() and exists(path):
        _remove(path)
    barrier()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # DCP's single-process notice
        _dcp().save(_flat_keys(flat), storage_writer=_writer(path),
                    process_group=group, no_dist=not dist_on)


def restore_sharded(path: str, like: Optional[Any] = None) -> Any:
    """A DCP snapshot as a nested dict. Without ``like`` every entry is
    read as a CPU tensor of its recorded shape and dtype (string leaves as
    strings); ``like`` (a nested dict of tensors) restores into its
    tensors' shapes, dtypes and devices. Every rank of the data axis
    calls it."""
    return _nest(_restore_flat(path, like))


def _restore_flat(path: str, like) -> dict:
    """{DCP key: value} of the snapshot at ``path``."""
    import torch

    path = str(path) if is_remote(path) else os.path.abspath(path)
    if not is_sharded(path):
        raise FileNotFoundError(f"{path}: no DCP snapshot ({METADATA} "
                                f"missing)")
    dcp = _dcp()
    if like is not None:
        flat = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in _flat_keys(_flatten(like)).items()}
    else:
        meta = _reader(path).read_metadata().state_dict_metadata
        flat = {}
        for k, m in meta.items():
            if isinstance(m, dcp.TensorStorageMetadata):
                flat[k] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
            else:
                flat[k] = ""
    group, dist_on = _group()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcp.load(flat, storage_reader=_reader(path), process_group=group,
                 no_dist=not dist_on)
    return flat


def read_leaves(path: str):
    """(leaves as numpy arrays, key paths) of a DCP snapshot, in sorted
    key-path order: what ``utils.file.load_leaves`` gives for a blob."""
    import torch

    flat = {tuple(k.split(SEP)): v
            for k, v in _restore_flat(path, None).items()}
    paths = sorted(flat)
    return [flat[kp].numpy() if isinstance(flat[kp], torch.Tensor)
            else np.asarray(flat[kp]) for kp in paths], paths


def save_leaves_sharded(path: str, leaves, key_paths,
                        overwrite: bool = False) -> None:
    """Leaves and their key paths (as ``utils.file.save_leaves`` takes
    them) as a DCP snapshot; visits the ``ckpt_save`` fault site once, as
    a blob write does."""
    from bigdl_tpu_torch.resilience.faults import hook

    hook("ckpt_save")
    _save_flat({tuple(kp): _leaf(v) for kp, v in zip(key_paths, leaves)},
               path, overwrite)


def restore_for_inference(path: str, model=None) -> tuple:
    """``(params, mod_state)`` of a training checkpoint, never reading the
    optimizer state. ``path`` may be a checkpoint directory (its newest
    ``model.<n>``; a ``state.<n>`` is ignored), one blob file, or one DCP
    snapshot directory. With a ``model`` (the port's module) the two are
    ``{name: tensor}`` dicts in the model's names and layouts, ready for
    ``load_state_dict``; without one, nested dicts of the checkpoint's
    key paths (a JAX blob then needs the model). A missing or corrupt
    checkpoint, or a ``state.<n>`` given as a model, raises ``SystemExit``
    with the path and the cause: one line, as the JAX package gives."""
    from bigdl_tpu_torch.utils.file import exists, isdir, latest_checkpoint

    path = str(path)
    if not exists(path):
        raise SystemExit(f"checkpoint {path}: does not exist")
    target = path
    if isdir(path):
        newest = latest_checkpoint(path, "model.")
        if newest is not None:
            target = newest
        else:  # the directory itself may be one DCP snapshot
            try:
                snapshot = is_sharded(path)
            except ValueError as e:  # a JAX orbax directory
                raise SystemExit(f"checkpoint {path}: {e}")
            if not snapshot:
                raise SystemExit(f"checkpoint {path}: no model.<n> "
                                 f"checkpoint in it, and it is not a DCP "
                                 f"snapshot")
    try:
        if model is not None:
            from bigdl_tpu_torch.interop.checkpoint import (is_model_blob,
                                                            load_model,
                                                            model_tensors)
            if not is_model_blob(target):
                raise _NotModel()
            tensors, _ = load_model(target, model)
            params, state = model_tensors(model)
            return ({k: tensors[k] for k in params},
                    {k: tensors[k] for k in state})
        if isdir(target):
            blob = restore_sharded(target)
        else:
            from bigdl_tpu_torch.utils.file import load_leaves
            leaves, paths = load_leaves(target)
            if paths is None:
                raise SystemExit(
                    f"checkpoint {target}: a JAX blob is read against the "
                    f"model it was written for: pass model=")
            blob = _nest(_flat_keys(dict(zip(paths, leaves))))
    except _NotModel:
        raise SystemExit(
            f"checkpoint {target}: not a model checkpoint (no 'params' "
            f"entry — did you point at a state.<n> optimizer blob?)")
    except SystemExit:
        raise
    except Exception as e:  # zip, npz, DCP and layout faults all land here
        raise SystemExit(f"checkpoint {target}: failed to load "
                         f"({type(e).__name__}: {e})")
    if not isinstance(blob, dict) or "params" not in blob:
        raise SystemExit(
            f"checkpoint {target}: not a model checkpoint (no 'params' "
            f"entry — did you point at a state.<n> optimizer blob?)")
    return blob["params"], blob.get("mod_state")


class _NotModel(Exception):
    pass
