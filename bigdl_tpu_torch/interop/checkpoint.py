"""Checkpoints the JAX package and the port can both read, without jax.

A JAX checkpoint blob is a pytree flattened by jax: ``leaf_i`` arrays in
jax's flatten order plus a pickled treedef, which only jax can unpickle.
Its order is the depth-first walk of the tree with each dict's keys
sorted as strings (children ``"0", "1", "10", "2"`` flatten in that
order), and an empty ``()`` state contributes no leaf. So the port reads
the leaves by position, against a target tree made from its own names:
a parameter or buffer ``a.b.weight`` stands at the JAX key path ``("a",
"b", "weight")``, under ``"params"`` or ``"mod_state"`` in a ``model.<n>``
blob (beside ``"driver"``, the loop's counters) and under the optimizer
state's own keys (``"velocity"``, ``"m"``, ...) in a ``state.<n>`` blob.
Each leaf's shape and dtype is held against the blob's manifest and the
target before anything loads; a module whose layout differs from JAX's
converts its leaves (``from_jax_leaf`` reading, ``to_jax_leaf`` writing:
the convolution's OIHW kernel is HWIO in JAX).

The port writes the same leaves in the same order and layouts, with the
key paths as JSON where the JAX blob has its treedef. Stated difference:
the JAX package's ``load_pytree`` cannot open a port blob (it has no
pickled treedef), but its leaves, unflattened with the JAX model's
treedef, are the JAX model's tree."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.file import (ChecksumError, load_leaves,
                                        read_manifest, save_leaves)

__all__ = ["DRIVER_KEYS", "model_tensors", "save_model", "load_model",
           "save_state", "load_state"]

# the training loop's counters in a model.<n> blob, in flatten order
DRIVER_KEYS = ("epoch", "epoch_records", "iteration", "rng_splits")


def model_tensors(model: torch.nn.Module) -> Tuple[dict, dict]:
    """({name: parameter}, {name: persistent buffer}) of ``model``: its
    JAX param tree and module-state tree."""
    params = dict(model.named_parameters())
    state = {k: v for k, v in model.state_dict(keep_vars=True).items()
             if k not in params}
    return params, state


def _flatten(tree: dict, names, prefix=()) -> List[tuple]:
    """[(key path, tensor name or None, leaf)] of a port tree: a key that
    is a parameter or buffer name opens into its dotted parts."""
    out = []
    for k, v in tree.items():
        named = k in names
        path = prefix + (tuple(k.split(".")) if named else (k,))
        if isinstance(v, dict):
            out += _flatten(v, names, path)
        else:
            out.append((path, k if named else None, v))
    return out


def _convert(modules: dict, name: Optional[str], attr: str, t):
    """``t`` through the ``attr`` layout converter of the module owning
    the tensor ``name`` (as it is where there is none)."""
    if name is None:
        return t
    owner, _, key = name.rpartition(".")
    fn = getattr(modules.get(owner), attr, None)
    return t if fn is None else fn(key, t)


def _to_numpy(modules, name, leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = _convert(modules, name, "to_jax_leaf", leaf.detach().cpu())
    return np.asarray(t.numpy(), order="C")


def _save(path: str, tree: dict, model) -> None:
    names = set(model.state_dict().keys())
    modules = dict(model.named_modules())
    flat = sorted(_flatten(tree, names), key=lambda e: e[0])
    save_leaves(path, [_to_numpy(modules, n, leaf) for _, n, leaf in flat],
                [p for p, _, _ in flat])


def save_model(path: str, model: torch.nn.Module,
               driver: Optional[dict] = None,
               tensors: Optional[dict] = None) -> None:
    """Write ``model``'s params and module state (and the loop's
    ``driver`` counters) as a ``model.<n>`` blob in the JAX layout;
    ``tensors`` ({name: tensor}, e.g. host copies) stand in for the
    model's own."""
    params, state = model_tensors(model)
    if tensors is not None:
        params = {k: tensors[k] for k in params}
        state = {k: tensors[k] for k in state}
    tree = {"params": params, "mod_state": state}
    if driver is not None:
        tree["driver"] = {k: int(driver[k]) for k in DRIVER_KEYS}
    _save(path, tree, model)


def save_state(path: str, opt_state: dict, model: torch.nn.Module) -> None:
    """Write an ``OptimMethod`` state as a ``state.<n>`` blob."""
    _save(path, opt_state, model)


def _read(path: str) -> Tuple[list, Optional[list]]:
    """The blob's leaves and key paths, held against its manifest."""
    leaves, paths = load_leaves(path)
    man = read_manifest(path)
    if man is not None:
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
                    f"the manifest says {rec.get('dtype')}"
                    f"{rec.get('shape')}")
    return leaves, paths


def _match(path: str, model, target: list, leaves: list
           ) -> Dict[tuple, object]:
    """{key path: tensor in the port's layout} of ``leaves`` laid on the
    sorted ``target`` [(path, name, like)], shapes and dtypes checked."""
    out = {}
    modules = dict(model.named_modules())
    for (kp, name, like), leaf in zip(target, leaves):
        t = _convert(modules, name, "from_jax_leaf",
                     torch.from_numpy(np.array(leaf)))
        if isinstance(like, torch.Tensor) and (
                tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype):
            raise ValueError(
                f"{path}: leaf {'.'.join(kp)} is {t.dtype}"
                f"{list(t.shape)}, the model has {like.dtype}"
                f"{list(like.shape)}")
        out[kp] = t
    return out


def _by_path(path: str, model, target: list, leaves: list,
             paths: Optional[list]) -> Dict[tuple, object]:
    if paths is None:  # a JAX blob: by position
        if len(leaves) != len(target):
            raise ValueError(f"{path}: {len(leaves)} leaves, the target "
                             f"tree has {len(target)}")
        return _match(path, model, target, leaves)
    have = dict(zip(paths, leaves))
    want = [kp for kp, _, _ in target]
    if set(have) != set(want):
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        raise ValueError(f"{path}: key paths differ from the target tree "
                         f"(missing {missing}, unexpected {extra})")
    return _match(path, model, target, [have[kp] for kp in want])


def load_model(path: str, model: torch.nn.Module
               ) -> Tuple[dict, Optional[dict]]:
    """({name: tensor} to ``load_state_dict`` into ``model``, the driver
    counters or None) of a ``model.<n>`` blob written by the port or the
    JAX package, or of a JAX params/mod_state file. A JAX driver must be
    the four :data:`DRIVER_KEYS` (which flatten before ``mod_state`` and
    ``params``); any other leaf count is refused."""
    params, state = model_tensors(model)
    names = set(params) | set(state)
    target = sorted(_flatten({"params": params, "mod_state": state}, names),
                    key=lambda e: e[0])
    leaves, paths = _read(path)
    driver = None
    if paths is None:
        extra = len(leaves) - len(target)
        if extra == len(DRIVER_KEYS):
            driver = {k: int(v) for k, v in zip(DRIVER_KEYS, leaves)}
            leaves = leaves[extra:]
        elif extra != 0:
            raise ValueError(
                f"{path}: {len(leaves)} leaves where the model has "
                f"{len(target)} (and a driver {len(DRIVER_KEYS)}): not a "
                f"checkpoint of this model")
    else:
        drv = {kp[1]: v for kp, v in zip(paths, leaves) if kp[0] == "driver"}
        if drv:
            driver = {k: int(v) for k, v in drv.items()}
        keep = [i for i, kp in enumerate(paths) if kp[0] != "driver"]
        leaves, paths = [leaves[i] for i in keep], [paths[i] for i in keep]
    got = _by_path(path, model, target, leaves, paths)
    return {name: got[kp] for kp, name, _ in target}, driver


def load_state(path: str, like: dict, model: torch.nn.Module) -> dict:
    """A ``state.<n>`` blob as a tree of the structure of ``like`` (an
    ``OptimMethod.init`` state of ``model``'s parameters), CPU tensors in
    the port's layouts."""
    names = set(model.state_dict().keys())
    target = sorted(_flatten(like, names), key=lambda e: e[0])
    leaves, paths = _read(path)
    got = _by_path(path, model, target, leaves, paths)

    def rebuild(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            kp = prefix + (tuple(k.split(".")) if k in names else (k,))
            out[k] = rebuild(v, kp) if isinstance(v, dict) else got[kp]
        return out

    return rebuild(like)
