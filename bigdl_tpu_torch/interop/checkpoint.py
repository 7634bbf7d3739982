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

A ``model.<n>`` driver holds the four counters, and with an executor
feed also the feed's epoch ``plan`` (:data:`PLAN_KEYS`, its ``mode`` a
string leaf): 4 or 13 leaves ahead of ``mod_state`` and ``params``.

The port writes the same leaves in the same order and layouts, with the
key paths as JSON where the JAX blob has its treedef. A whole-model file
(``utils.file.save_module``, or the JAX package's) holds a ``__module__``
leaf beside ``params`` and ``mod_state``: loading its weights skips it. Stated difference:
the JAX package's ``load_pytree`` cannot open a port blob (it has no
pickled treedef), but its leaves, unflattened with the JAX model's
treedef, are the JAX model's tree."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.file import (MODULE_KEY, check_manifest, isdir,
                                        is_jax_module_file, load_leaves,
                                        save_leaves)

__all__ = ["DRIVER_KEYS", "PLAN_KEYS", "model_tensors", "save_model",
           "load_model", "save_state", "load_state", "is_model_blob"]

# the training loop's counters in a model.<n> blob, in flatten order
DRIVER_KEYS = ("epoch", "epoch_records", "iteration", "rng_splits")
# an executor feed's EpochPlan.signature() under driver/plan, in flatten
# order (between "iteration" and "rng_splits")
PLAN_KEYS = ("batch", "epoch", "global_batch", "host", "hosts", "mode", "n",
             "seed", "shuffle")


def _plan_leaf(v):
    return v if isinstance(v, (bool, str)) else int(v)


def _driver_from(counters: dict, plan: Optional[dict]) -> dict:
    """The driver dict of a blob's leaves: int counters, and the plan's
    values as Python scalars (``mode`` a str, ``shuffle`` a bool)."""
    drv = {k: int(v) for k, v in counters.items()}
    if plan:
        drv["plan"] = {k: np.asarray(v).item() for k, v in plan.items()}
    return drv


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


def _save(path: str, tree: dict, model, layout: Optional[dict],
          sharded: bool = False) -> None:
    names = set(model.state_dict().keys())
    modules = dict(model.named_modules())
    flat = sorted(_flatten(tree, names), key=lambda e: e[0])
    leaves = [_to_numpy(modules, n, leaf) for _, n, leaf in flat]
    paths = [p for p, _, _ in flat]
    if sharded:  # a DCP snapshot directory; every rank calls this
        from bigdl_tpu_torch.utils.orbax_ckpt import save_leaves_sharded
        save_leaves_sharded(path, leaves, paths, overwrite=True)
        return
    save_leaves(path, leaves, paths, layout)


def save_model(path: str, model: torch.nn.Module,
               driver: Optional[dict] = None,
               tensors: Optional[dict] = None,
               layout: Optional[dict] = None, sharded: bool = False) -> None:
    """Write ``model``'s params and module state (and the loop's
    ``driver`` counters) as a ``model.<n>`` blob in the JAX layout;
    ``tensors`` ({name: tensor}, e.g. host copies) stand in for the
    model's own; ``layout`` (a ``DataParallel.layout_signature()``) goes
    into the manifest. ``sharded`` writes the same leaves as a DCP
    snapshot directory (``utils.orbax_ckpt``) instead."""
    params, state = model_tensors(model)
    if tensors is not None:
        params = {k: tensors[k] for k in params}
        state = {k: tensors[k] for k in state}
    tree = {"params": params, "mod_state": state}
    if driver is not None:
        tree["driver"] = {k: int(driver[k]) for k in DRIVER_KEYS}
        if driver.get("plan"):
            plan = driver["plan"]
            if set(plan) != set(PLAN_KEYS):
                raise ValueError(f"a driver plan has the keys {PLAN_KEYS}, "
                                 f"got {sorted(plan)}")
            tree["driver"]["plan"] = {k: _plan_leaf(plan[k])
                                      for k in PLAN_KEYS}
    _save(path, tree, model, layout, sharded)


def save_state(path: str, opt_state: dict, model: torch.nn.Module,
               layout: Optional[dict] = None, sharded: bool = False) -> None:
    """Write an ``OptimMethod`` state as a ``state.<n>`` blob (a DCP
    snapshot directory with ``sharded``)."""
    _save(path, opt_state, model, layout, sharded)


def _read(path: str) -> Tuple[list, Optional[list]]:
    """The leaves and key paths of a blob, held against its manifest, or
    of a DCP snapshot directory (which visits the ``ckpt_restore`` fault
    site once, as a blob does)."""
    if isdir(path):
        from bigdl_tpu_torch.resilience.faults import hook
        from bigdl_tpu_torch.utils.orbax_ckpt import read_leaves
        hook("ckpt_restore")
        return read_leaves(path)
    leaves, paths = load_leaves(path)
    check_manifest(path, leaves)
    return leaves, paths


def is_model_blob(path: str) -> bool:
    """Whether ``path`` (a blob or a DCP snapshot) holds ``params``: false
    for a ``state.<n>``. A JAX blob, whose key paths are not stored, is
    taken as one (loading it against a model checks its leaves)."""
    import json

    from bigdl_tpu_torch.utils.file import PATHS_KEY, _fs_for, is_remote
    if isdir(path):
        from bigdl_tpu_torch.utils.orbax_ckpt import SEP, _reader, is_sharded
        if not is_sharded(path):
            return False
        keys = _reader(path).read_metadata().state_dict_metadata
        return any(k.split(SEP, 1)[0] == "params" for k in keys)
    if is_remote(path):
        import io
        fs, p = _fs_for(path)
        with fs.open(p, "rb") as f:
            src = io.BytesIO(f.read())
    else:
        src = path
    with np.load(src, allow_pickle=False) as z:
        if PATHS_KEY not in z.files:
            return True
        return any(p[0] == "params"
                   for p in json.loads(z[PATHS_KEY].tobytes()))


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
    or None) of a ``model.<n>`` blob written by the port or the JAX
    package, or of a JAX params/mod_state file. A JAX driver is the four
    :data:`DRIVER_KEYS`, or those and the nine :data:`PLAN_KEYS` of an
    executor feed's plan (they flatten before ``mod_state`` and
    ``params``); any other leaf count is refused. The driver's counters
    are ints, its ``plan`` (when there is one) a dict of Python
    scalars."""
    params, state = model_tensors(model)
    names = set(params) | set(state)
    target = sorted(_flatten({"params": params, "mod_state": state}, names),
                    key=lambda e: e[0])
    leaves, paths = _read(path)
    driver = None
    if paths is None:
        if not isdir(path) and is_jax_module_file(path):
            # a JAX whole-model file: its pickled definition sorts first
            leaves = leaves[1:]
        extra = len(leaves) - len(target)
        n_plan = len(DRIVER_KEYS) + len(PLAN_KEYS)
        if extra == len(DRIVER_KEYS):
            driver = _driver_from(dict(zip(DRIVER_KEYS, leaves)), None)
        elif extra == n_plan:
            # epoch, epoch_records, iteration, plan/..., rng_splits
            head = len(DRIVER_KEYS) - 1
            driver = _driver_from(
                dict(zip(DRIVER_KEYS, leaves[:head] + [leaves[n_plan - 1]])),
                dict(zip(PLAN_KEYS, leaves[head:n_plan - 1])))
        elif extra != 0:
            raise ValueError(
                f"{path}: {len(leaves)} leaves where the model has "
                f"{len(target)} (and a driver {len(DRIVER_KEYS)} or "
                f"{n_plan}): not a checkpoint of this model")
        leaves = leaves[extra:]
    else:
        counters = {kp[1]: v for kp, v in zip(paths, leaves)
                    if kp[0] == "driver" and len(kp) == 2}
        plan = {kp[2]: v for kp, v in zip(paths, leaves)
                if kp[0] == "driver" and len(kp) == 3 and kp[1] == "plan"}
        if counters:
            driver = _driver_from(counters, plan)
        keep = [i for i, kp in enumerate(paths)
                if kp[0] not in ("driver", MODULE_KEY)]
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
