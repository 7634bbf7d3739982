"""Process-group bring-up and the data mesh (counterpart of
``bigdl_tpu/parallel/mesh.py``; reference utils/Engine.scala:305-337).

The JAX package runs one process per host and lays a named
``jax.sharding.Mesh`` over the host's chips. The port runs one process per
GPU, started by ``torchrun`` (or by :func:`bigdl_tpu_torch.parallel.launch.
spawn`), joined by ``torch.distributed``: NCCL on the card, gloo on the
CPU. A :class:`Mesh` names the data axis of that process group; its
``size`` and ``shape`` read as the JAX mesh's do, so code that reads
``strategy.mesh`` keeps its shape. Only the ``data`` axis is ported: the
model, sequence and pipeline axes come with tensor, sequence and pipeline
parallelism (ROADMAP.md queue 1 entry 13).

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
import os
from typing import Optional

import torch

__all__ = ["Mesh", "init_distributed", "make_mesh", "local_mesh",
           "axis_group", "live_group", "TIMEOUT_S"]

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
    """A one-axis device mesh over the job's process group: ``axis_names``,
    ``shape`` ({name: size}), ``size``, the ``group`` its collectives take
    (None: the default group), this process's ``rank`` in it (-1 when it
    is not a ``member``) and the global ``ranks`` it spans. Collectives run
    on the device of the tensors they are given: the card under NCCL,
    either under gloo."""

    def __init__(self, axis: str, size: int, rank: int = 0, group=None,
                 ranks=None):
        self.axis_names = (axis,)
        self.shape = {axis: int(size)}
        self.size = int(size)
        self.group = group
        self.rank = int(rank)
        self.ranks = list(range(int(size)) if ranks is None else ranks)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def global_rank(self, rank: int) -> int:
        """The job's rank of the mesh's ``rank`` (what ``src``/``dst`` of
        a ``torch.distributed`` call name)."""
        return self.ranks[rank]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _refuse_axes(axes: dict) -> None:
    other = [a for a in axes if a != "data"]
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not in the PyTorch port yet: the model, "
            f"sequence and pipeline axes come with tensor, sequence and "
            f"pipeline parallelism (ROADMAP.md queue 1 entry 13); the port "
            f"has the 'data' axis")


# the newest mesh made over a subset of the job's ranks (an elastic
# re-formation), or None: the default group is the live one
_LIVE: Optional[Mesh] = None


def make_mesh(axes: dict, devices=None) -> Mesh:
    """``make_mesh({"data": n})``: the data axis over the process group's
    ``n`` ranks (-1 fills it with them all). ``n`` must be the world size,
    as the JAX mesh's sizes must multiply to the device count; one process
    with no group is a mesh of one. ``devices``, a list of the job's ranks
    (the survivors of an elastic loss), builds the axis over those ranks
    alone, on a new process group; every rank of the job must call it
    with the same list, in the same order as its other ``make_mesh``
    calls."""
    global _LIVE
    _refuse_axes(axes)
    if "data" not in axes:
        raise ValueError(f"make_mesh needs a 'data' axis, got {axes}")
    dist = _dist()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
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


def local_mesh(data_axis: str = "data") -> Mesh:
    """Every rank of the job on one data axis (the JAX ``local_mesh``)."""
    _refuse_axes({data_axis: 1})
    return make_mesh({data_axis: -1})


def axis_group(axis_name: str):
    """(process group, size) of the mesh axis ``axis_name``: the live
    mesh's (after an elastic re-formation, the survivors' group), else the
    job's default group and its size, or (None, 1) in a single process."""
    _refuse_axes({axis_name: 1})
    dist = _dist()
    if not dist.is_initialized():
        return None, 1
    if _LIVE is not None:
        return _LIVE.group, _LIVE.size
    return None, dist.get_world_size()


def live_group():
    """The process group the job's live ranks share: the newest elastic
    mesh's, else None (the default group)."""
    return None if _LIVE is None else _LIVE.group
