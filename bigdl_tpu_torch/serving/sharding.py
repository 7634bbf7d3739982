"""Tensor-parallel placement for the serving stack (counterpart of
``bigdl_tpu/serving/sharding.py``).

Serving reuses the training side's Megatron rules
(``parallel.tensor_parallel.megatron_specs``), so a checkpoint trained
under any topology serves under any other. The KV side follows the
attention's heads: each rank's cache holds the KV heads of its slice
(``kv_spec`` splits the head dim when K divides it and replicates it
otherwise, where each rank keeps the whole cache and reads the heads its
query heads need).

* :class:`ServingSharding`: one replica's mesh and the placement rules
  (params through ``megatron_specs``, a quantized weight's scale through
  :meth:`ServingSharding.scale_spec`, KV leaves through
  :meth:`ServingSharding.kv_spec`).
* :func:`replica_device_groups`: the devices of ``dp:N`` replicas, N
  disjoint groups of K (``devices`` may name one device twice, as the
  one-card machine's ``[cuda:0, cuda:0]`` and the CPU's ``["cpu"] * 4``).
* :func:`serving_mesh`: the one-axis ``model`` mesh of a ``tp:K`` engine,
  over K ranks of the job (one process a rank).
* :func:`replica_meshes`: the meshes of ``dp:N+tp:K``: every one of the
  K ranks holds its shard of all N replicas, each replica's mesh over the
  K ranks with a process group of its own, so that the replicas'
  collectives (and their leaders' broadcasts) do not queue behind each
  other. The JAX package runs one process with a mesh a replica over
  disjoint devices; here a rank's N shards share its device (or take the
  devices ``--devices`` names).
* :func:`restore_for_serving`: a training checkpoint, of any topology, as
  whole tensors for the engine to place.
* :class:`TPLink`: the leader and followers of a ``tp:K`` engine. Rank 0
  keeps the HTTP front, the batcher, the slot and page bookkeeping and
  sampling (host structures are not sharded, as in the JAX package);
  ranks 1..K-1 run :meth:`TPLink.serve`. At each call of a device program
  rank 0 broadcasts the program's name and its host inputs, and every
  rank runs the same program on its shards; a handler learns every rank's
  outcome through :meth:`TPLink.agree` (a fleet worker's weight swap).

Stated differences from the JAX package: the tp engine runs its programs
eagerly (gloo's collectives cannot be captured in a CUDA graph), and GQA
at a K that does not divide the KV heads keeps the cache whole on every
rank (see ``parallel.tensor_parallel``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from bigdl_tpu_torch.parallel.mesh import Mesh

__all__ = ["ServingSharding", "serving_mesh", "replica_meshes",
           "replica_device_groups", "restore_for_serving", "TPLink"]


def replica_device_groups(n_replicas: int, tp_k: int = 1,
                          devices: Optional[Sequence] = None) -> List[list]:
    """``n_replicas`` disjoint groups of ``tp_k`` devices each, contiguous
    slices of ``devices`` (default: every visible card, else the CPU
    once). Leftover devices stay idle."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device(f"cuda:{i}") for i in range(n)]
                   or [torch.device("cpu")])
    devices = list(devices)
    need = int(n_replicas) * int(tp_k)
    if need > len(devices):
        raise ValueError(
            f"{n_replicas} replicas x {tp_k}-way tp needs {need} devices, "
            f"have {len(devices)}")
    return [devices[r * tp_k:(r + 1) * tp_k] for r in range(n_replicas)]


def serving_mesh(devices: Optional[Sequence[int]] = None,
                 axis: str = "model") -> Mesh:
    """The one-axis ``axis`` mesh of a tp engine over the job's ranks
    ``devices`` (default all of them, one process a rank; serving has no
    data axis inside a replica). Every rank of the job calls it."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = list(range(world)) if devices is None else [int(d) for d in
                                                        devices]
    group = None
    if dist.is_initialized() and len(ranks) != world:
        group = dist.new_group(ranks)
    return Mesh(axis, len(ranks), ranks.index(me) if me in ranks else -1,
                group=group, ranks=ranks)


def replica_meshes(n_replicas: int, axis: str = "model") -> List[Mesh]:
    """``n_replicas`` one-axis ``axis`` meshes over every rank of the job:
    one (the job's default group) for a single replica, else a new process
    group each. Every rank calls it, in the same order."""
    import torch.distributed as dist

    if int(n_replicas) <= 1:
        return [serving_mesh(axis=axis)]
    world = dist.get_world_size()
    me = dist.get_rank()
    ranks = list(range(world))
    return [Mesh(axis, world, me, group=dist.new_group(ranks), ranks=ranks)
            for _ in range(int(n_replicas))]


class ServingSharding:
    """Placement rules of one tensor-parallel serving replica over
    ``mesh``'s ``axis``. ``n_shard == 1`` replicates everything."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh {dict(mesh.shape)} has no {axis!r} axis")
        self.mesh = mesh
        self.axis = axis
        self.n_shard = int(mesh.shape[axis])

    def param_specs(self, module, params=None):
        """The spec tree of ``module``'s parameters (JAX paths): the
        training side's Megatron layout when tp > 1, all replicated
        otherwise. A quantized weight is one leaf (its weight's spec)."""
        from bigdl_tpu_torch.parallel.tensor_parallel import (
            megatron_specs, param_tree, replicated_specs)

        params = param_tree(module) if params is None else params
        if self.n_shard <= 1:
            return replicated_specs(params)
        return megatron_specs(module, params, self.axis, self.n_shard)

    def scale_spec(self, weight_spec):
        """A quantized weight's per-output-channel scale: split exactly
        when the weight's axis 1 is split; replicated otherwise (a
        row-split weight contracts over its axis 0, so every rank needs
        every output scale)."""
        ws = tuple(weight_spec or ())
        if len(ws) >= 2 and ws[1] is not None:
            return (ws[1],)
        return ()

    def place_params(self, module):
        """Place ``module`` (its quantized weights too) under the Megatron
        layout on this rank: each split leaf becomes this rank's slice and
        the split modules take their ``_tp`` state. The split leaves'
        ``{name: (dim, whole size)}`` are kept as ``module._tp_split``
        (what a weight swap reads a whole checkpoint against). Returns the
        module."""
        if self.n_shard > 1:
            from bigdl_tpu_torch.parallel.tensor_parallel import apply_specs
            module._tp_split = apply_specs(module, self.param_specs(module),
                                           self.mesh, self.axis)
        return module

    def kv_spec(self, leaf):
        """KV leaves are ``(slots|pages, kv_heads, tokens, head_dim)``:
        the head dim split when tp divides it, else replicated."""
        shape = tuple(getattr(leaf, "shape", ()))
        if (self.n_shard > 1 and len(shape) == 4
                and shape[1] % self.n_shard == 0):
            return (None, self.axis, None, None)
        return ()


def restore_for_serving(path: str, model) -> tuple:
    """``(params, mod_state)`` of a training checkpoint written under any
    topology (its blobs hold whole tensors): ``{name: tensor}`` dicts in
    ``model``'s names, for ``load_state_dict`` before the engine places
    the model. A directory's newest ``model.<n>``, one blob or one DCP
    snapshot; a missing or corrupt checkpoint raises ``SystemExit`` (the
    ``restore_for_inference`` contract)."""
    from bigdl_tpu_torch.utils.orbax_ckpt import restore_for_inference
    return restore_for_inference(path, model)


class TPLink:
    """The leader and followers of one tp engine over the model-axis mesh
    ``mesh``. Handlers are registered by name on every rank
    (:meth:`register`); the leader's :meth:`call` broadcasts the name and
    the host inputs and runs the handler; a follower's :meth:`serve` runs
    each broadcast call until the leader's :meth:`close`. Calls are made
    in one order (the engines' pool lock serialises them)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = int(mesh.size)
        self.rank = int(mesh.rank)
        self.leader = self.rank == 0
        self._handlers: dict = {}
        self._closed = False
        self.calls = 0

    def register(self, name: str, fn: Callable) -> None:
        if name in self._handlers:
            raise ValueError(f"a tp handler named {name!r} exists")
        self._handlers[name] = fn

    def _broadcast(self, obj):
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=self.mesh.global_rank(0),
                                   group=self.mesh.group)
        return box[0]

    def call(self, name: str, *args):
        """On the leader: every rank runs handler ``name`` with ``args``
        (host values); returns the leader's result."""
        if not self.leader:
            raise RuntimeError("only the tp leader (rank 0) calls")
        if self.size > 1:
            self._broadcast((name, args))
        self.calls += 1
        return self._handlers[name](*args)

    def serve(self) -> int:
        """A follower's loop: run every call the leader broadcasts until
        it closes; returns the number of calls run."""
        if self.leader:
            raise RuntimeError("the tp leader does not follow")
        while True:
            name, args = self._broadcast(None)
            if name == "close":
                return self.calls
            self._handlers[name](*args)
            self.calls += 1

    def agree(self, value) -> list:
        """Every rank's ``value``, in rank order: a handler calls it on
        every rank together, so that each learns what all of them did (a
        weight swap's per-rank verdicts)."""
        if self.size <= 1:
            return [value]
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, value, group=self.mesh.group)
        return out

    def close(self) -> None:
        """On the leader: release the followers (idempotent)."""
        if self.leader and self.size > 1 and not self._closed:
            self._closed = True
            self._broadcast(("close", ()))
