"""Process-group bring-up and the data mesh (counterpart of
``bigdl_tpu/parallel/mesh.py``; reference utils/Engine.scala:305-337).

The JAX package runs one process per host and lays a named
``jax.sharding.Mesh`` over the host's chips. The port runs one process per
GPU, started by ``torchrun`` (or by :func:`bigdl_tpu_torch.parallel.launch.
spawn`), joined by ``torch.distributed``: NCCL on the card, gloo on the
CPU. A :class:`Mesh` names the axes of that process group; its
``size`` and ``shape`` read as the JAX mesh's do, so code that reads
``strategy.mesh`` keeps its shape. ``make_mesh({"data": d, "model": k})``
lays the ranks out in the JAX order (``model`` innermost) with one
``new_group`` for each line of each axis; :func:`make_hybrid_mesh` puts
the DCN axes across torchrun nodes and the ICI axes within one. The
``data`` and ``model`` axes are ported; the sequence, pipeline and expert
axes come with ROADMAP.md queue 1 entry 13(b).

Elastic re-formation (``resilience.elastic``): ``make_mesh(axes,
devices)`` with the surviving ranks (``resilience.faults.
healthy_devices()``) builds the data axis over them alone, on a
``new_group`` of those ranks. Every rank of the job calls it, the lost
ones too (``new_group`` is collective over the default group); a lost
rank gets a mesh it is not a member of (``member`` false) and leaves the
job. The newest such mesh is the one :func:`axis_group` and
:func:`live_group` answer for, so batch norm, the barriers and the
checkpoints of the survivors never wait for a rank that has left. Stated
difference: the JAX package re-forms over surviving devices of one
process; the port re-forms over surviving processes.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["Mesh", "init_distributed", "make_mesh", "make_hybrid_mesh",
           "hybrid_layout", "local_mesh", "axis_group", "live_group",
           "live_size", "TIMEOUT_S"]

# a collective that waits longer than this raises (gloo) or is aborted by
# the watchdog (NCCL): a hung rank fails the run instead of stalling it
TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist
    return dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join this process to the job's process group (the JAX
    ``jax.distributed.initialize`` call). The address, the process count
    and this process's rank come from the arguments, else from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
    ``LOCAL_RANK`` picks the card. A single process is a no-op unless
    ``num_processes=1`` and a ``backend`` are both given, which makes a
    group of one (a one-rank NCCL group runs the collectives of a
    multi-rank step on one card).

    The backend is NCCL where CUDA is available (after
    ``torch.cuda.set_device(local_rank)``) and gloo on the CPU; more ranks
    on one host than cards raises for NCCL, which never switches backend
    on its own. An explicit ``backend="gloo"`` on a machine with cards
    puts rank ``local_rank`` on card ``local_rank % count``, so several
    ranks may share one card (gloo reduces CUDA tensors through the
    host). A group that is already initialised is left as it is."""
    dist = _dist()
    if dist.is_initialized():
        return
    env = os.environ
    n = int(num_processes if num_processes is not None
            else env.get("WORLD_SIZE", 1))
    if n <= 1 and (backend is None or num_processes is None):
        return
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    local = int(env.get("LOCAL_RANK", rank))
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= cards:
            raise RuntimeError(
                f"NCCL needs one card a rank: local rank {local} on a host "
                f"with {cards} card(s); start fewer processes, or name "
                f"backend='gloo' to share cards")
        torch.cuda.set_device(local)
    elif torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


class Mesh:
    """A device mesh over the job's process group: ``axis_names``,
    ``shape`` ({name: size}, in the order the axes were given), ``size``,
    the ``group`` a one-axis mesh's collectives take (None: the default
    group), this process's ``rank`` in it (-1 when it is not a
    ``member``) and the global ``ranks`` it spans, in mesh order (the
    last axis innermost). ``Mesh("data", n, rank)`` is a one-axis mesh;
    ``Mesh({"data": d, "model": k}, ...)`` a mesh of several axes, whose
    per-axis process groups :meth:`axis_view` answers for. Collectives run
    on the device of the tensors they are given: the card under NCCL,
    either under gloo."""

    def __init__(self, axis, size: Optional[int] = None, rank: int = 0,
                 group=None, ranks=None, axis_groups=None):
        if isinstance(axis, str):
            axes = {axis: int(size)}
        else:
            axes = {str(k): int(v) for k, v in dict(axis).items()}
        self.axis_names = tuple(axes)
        self.shape = axes
        self.size = int(math.prod(axes.values()))
        self.group = group
        self.rank = int(rank)
        self.ranks = list(range(self.size) if ranks is None else ranks)
        # {axis: (process group, the global ranks of this rank's line
        # along the axis, this rank's index on it)}
        self._axis_groups = dict(axis_groups or {})

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def global_rank(self, rank: int) -> int:
        """The job's rank of the mesh's ``rank`` (what ``src``/``dst`` of
        a ``torch.distributed`` call name)."""
        return self.ranks[rank]

    def axis_view(self, axis: str) -> "Mesh":
        """The one-axis mesh of this rank's line along ``axis``: its
        process group, size, this rank's index on it and the line's global
        ranks (a one-axis mesh is its own view)."""
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        if len(self.axis_names) == 1:
            return self
        group, ranks, idx = self._axis_groups[axis]
        return Mesh(axis, len(ranks), idx, group=group, ranks=ranks)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


# axes whose parallelism is not in the port yet (ROADMAP.md queue 1
# entry 13(b): sequence, pipeline and expert parallelism)
_LATER_AXES = ("seq", "pipe", "expert")


def _refuse_axes(axes: dict) -> None:
    other = [a for a in axes if a in _LATER_AXES]
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not in the PyTorch port yet: the "
            f"sequence, pipeline and expert axes come with sequence, "
            f"pipeline and expert parallelism (ROADMAP.md queue 1 entry "
            f"13(b)); the port has the 'data' and 'model' axes")


# the newest mesh made over a subset of the job's ranks (an elastic
# re-formation), or None: the default group is the live one
_LIVE: Optional[Mesh] = None
# the newest mesh of more than one axis (its axis groups answer
# axis_group), or None
_CURRENT: Optional[Mesh] = None


def _resolve_sizes(axes: dict, total: int, what: str = "mesh") -> dict:
    """Axis sizes with one -1 filled from ``total``; they must multiply to
    ``total``."""
    sizes = {str(k): int(v) for k, v in axes.items()}
    if list(sizes.values()).count(-1) > 1:
        raise ValueError(f"{what} {axes}: at most one axis may be -1")
    for k, v in sizes.items():
        if v == -1:
            known = math.prod(s for s in sizes.values() if s != -1)
            sizes[k] = total // max(known, 1)
    if math.prod(sizes.values()) != total:
        raise ValueError(f"{what} {sizes} needs {math.prod(sizes.values())}"
                         f" devices, have {total} (one process a device: "
                         f"start {math.prod(sizes.values())} with torchrun "
                         f"--nproc_per_node N)")
    return sizes


def _build(sizes: dict, layout: np.ndarray, world: int) -> Mesh:
    """The mesh of ``layout`` (an array of global ranks shaped by
    ``sizes``), with one process group for every line along every axis
    of more than one. Every rank of the job makes every group, in the
    same order (``new_group`` is collective over the default group)."""
    dist = _dist()
    me = dist.get_rank() if dist.is_initialized() else 0
    names = list(sizes)
    flat = [int(r) for r in layout.reshape(-1)]
    rank = flat.index(me) if me in flat else -1
    axis_groups = {}
    for i, name in enumerate(names):
        lines = np.moveaxis(layout, i, -1).reshape(-1, sizes[name])
        for line in lines:
            line = [int(r) for r in line]
            group = (dist.new_group(line) if dist.is_initialized()
                     and len(line) > 1 else None)
            if me in line:
                axis_groups[name] = (group, line, line.index(me))
    whole = (None if len(flat) == world or not dist.is_initialized()
             else dist.new_group(sorted(flat)))
    return Mesh(sizes, rank=rank, group=whole, ranks=flat,
                axis_groups=axis_groups)


def make_mesh(axes: dict, devices=None) -> Mesh:
    """``make_mesh({"data": n})``: the data axis over the process group's
    ``n`` ranks (-1 fills it with them all); ``make_mesh({"data": d,
    "model": k})``: the job's ranks laid out in the JAX order, the last
    axis innermost (the ranks of one tensor-parallel group are adjacent),
    one process group for each line of each axis. The sizes must multiply
    to the world size, as the JAX mesh's sizes must multiply to the device
    count; one process with no group is a mesh of one. ``devices``, a list
    of the job's ranks (the survivors of an elastic loss), builds a
    one-axis data mesh over those ranks alone, on a new process group;
    every rank of the job must call it with the same list, in the same
    order as its other ``make_mesh`` calls."""
    global _LIVE, _CURRENT
    _refuse_axes(axes)
    dist = _dist()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if len(axes) > 1:
        if devices is not None:
            raise ValueError("devices= re-forms a one-axis data mesh; a "
                             "mesh of several axes spans the job's ranks")
        sizes = _resolve_sizes(axes, world)
        mesh = _build(sizes, np.arange(world).reshape(
            list(sizes.values())), world)
        _LIVE, _CURRENT = None, mesh
        return mesh
    if "data" not in axes:
        raise ValueError(f"make_mesh needs a 'data' axis, got {axes}")
    _CURRENT = None
    ranks = list(range(world)) if devices is None else sorted(
        int(d) for d in devices)
    if any(r < 0 or r >= world for r in ranks) or not ranks:
        raise ValueError(f"devices {list(devices)} are not ranks of this "
                         f"job's {world}")
    n = int(axes["data"])
    if n == -1:
        n = len(ranks)
    if n != len(ranks):
        raise ValueError(f"mesh {{'data': {n}}} needs {n} devices, have "
                         f"{len(ranks)} (one process a device: start {n} "
                         f"with torchrun --nproc_per_node {n})")
    if devices is None or len(ranks) == world:
        _LIVE = None
        return Mesh("data", n, rank)
    group = dist.new_group(ranks) if dist.is_initialized() else None
    mesh = Mesh("data", n, ranks.index(rank) if rank in ranks else -1,
                group=group, ranks=ranks)
    _LIVE = mesh
    return mesh


def hybrid_layout(dcn_axes: dict, ici_axes: dict, world: int,
                  local_world: Optional[int] = None,
                  num_slices: Optional[int] = None):
    """``(sizes, layout)`` of :func:`make_hybrid_mesh` over ``world``
    ranks: the ranks grouped into slices by node (``local_world`` ranks a
    node, contiguous, as torchrun numbers them), or, on one node, into
    ``num_slices`` equal contiguous virtual slices; the DCN axes across
    the slices (outermost), the ICI axes within one. ``layout`` is the
    array of global ranks shaped by ``sizes`` (DCN axes, then ICI axes):
    the JAX ``make_hybrid_mesh`` layout of devices 0..world-1."""
    ranks = list(range(int(world)))
    per_node = int(local_world or world)
    if per_node < 1 or world % per_node:
        raise ValueError(f"{world} ranks do not split into nodes of "
                         f"{per_node}")
    slices = [ranks[i:i + per_node] for i in range(0, world, per_node)]
    if len(slices) == 1 and num_slices and num_slices > 1:
        if world % num_slices:
            raise ValueError(f"{world} devices do not split into "
                             f"{num_slices} equal virtual slices")
        per = world // num_slices
        slices = [ranks[i * per:(i + 1) * per] for i in range(num_slices)]
    dcn = _resolve_sizes(dcn_axes, len(slices), "dcn axes")
    ici = _resolve_sizes(ici_axes, len(slices[0]), "ici axes")
    if set(dcn) & set(ici):
        raise ValueError(f"axes {sorted(set(dcn) & set(ici))} are both "
                         f"DCN and ICI axes")
    sizes = {**dcn, **ici}
    return sizes, np.asarray(slices).reshape(list(sizes.values()))


def make_hybrid_mesh(dcn_axes: dict, ici_axes: dict,
                     num_slices: Optional[int] = None) -> Mesh:
    """A mesh spanning several nodes (the JAX package's TPU slices joined
    by DCN): ``dcn_axes`` laid out across nodes, outermost, so their
    collectives cross the network between hosts; ``ici_axes`` within a
    node, over NVLink. A node is a torchrun node: ``LOCAL_WORLD_SIZE``
    ranks numbered contiguously. ``num_slices`` splits one node into that
    many equal virtual slices, as the JAX function does when the runtime
    reports one slice. The product of ``dcn_axes`` is the slice count,
    that of ``ici_axes`` the ranks a slice (one -1 allowed in each). The
    mesh spans the job's ranks (the JAX function's ``devices`` is the
    process group here)."""
    global _LIVE, _CURRENT
    _refuse_axes({**dcn_axes, **ici_axes})
    dist = _dist()
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    sizes, layout = hybrid_layout(dcn_axes, ici_axes, world, local,
                                  num_slices)
    mesh = _build(sizes, layout, world)
    if len(sizes) == 1:
        mesh = Mesh(next(iter(sizes)), world, mesh.rank)
    _LIVE, _CURRENT = None, (mesh if len(sizes) > 1 else None)
    return mesh


def local_mesh(data_axis: str = "data") -> Mesh:
    """Every rank of the job on one data axis (the JAX ``local_mesh``)."""
    if data_axis != "data":
        raise ValueError(f"local_mesh lays the ranks on the 'data' axis, "
                         f"got {data_axis!r}")
    return make_mesh({data_axis: -1})


def axis_group(axis_name: str):
    """(process group, size) of the mesh axis ``axis_name``: the live
    mesh's data axis (after an elastic re-formation, the survivors'
    group), else this rank's line along the axis of the newest mesh of
    several axes, else, for ``data``, the job's default group and its
    size, or (None, 1) in a single process."""
    _refuse_axes({axis_name: 1})
    dist = _dist()
    if not dist.is_initialized():
        return None, 1
    if _LIVE is not None and axis_name == "data":
        return _LIVE.group, _LIVE.size
    if _CURRENT is not None and axis_name in _CURRENT.shape:
        view = _CURRENT.axis_view(axis_name)
        return view.group, view.size
    if axis_name != "data":
        raise ValueError(f"no mesh with a {axis_name!r} axis: make one "
                         f"with make_mesh({{'data': d, {axis_name!r}: k}})")
    return None, dist.get_world_size()


def live_size() -> int:
    """The rank count of the job's live ranks: the newest elastic mesh's,
    else the world size (1 in a single process)."""
    dist = _dist()
    if not dist.is_initialized():
        return 1
    return _LIVE.size if _LIVE is not None else dist.get_world_size()


def live_group():
    """The process group the job's live ranks share: the newest elastic
    mesh's, else None (the default group)."""
    return None if _LIVE is None else _LIVE.group
