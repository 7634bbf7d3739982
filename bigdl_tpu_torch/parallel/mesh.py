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
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

__all__ = ["Mesh", "init_distributed", "make_mesh", "local_mesh",
           "axis_group", "TIMEOUT_S"]

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
    (None: the default group) and this process's ``rank``. Collectives run
    on the device of the tensors they are given: the card under NCCL,
    either under gloo."""

    def __init__(self, axis: str, size: int, rank: int = 0):
        self.axis_names = (axis,)
        self.shape = {axis: int(size)}
        self.size = int(size)
        self.group = None
        self.rank = int(rank)

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


def make_mesh(axes: dict, devices=None) -> Mesh:
    """``make_mesh({"data": n})``: the data axis over the process group's
    ``n`` ranks (-1 fills it with them all). ``n`` must be the world size,
    as the JAX mesh's sizes must multiply to the device count; one process
    with no group is a mesh of one."""
    if devices is not None:
        raise ValueError("the port's mesh is its process group: pass no "
                         "device list")
    _refuse_axes(axes)
    if "data" not in axes:
        raise ValueError(f"make_mesh needs a 'data' axis, got {axes}")
    dist = _dist()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = int(axes["data"])
    if n == -1:
        n = world
    if n != world:
        raise ValueError(f"mesh {{'data': {n}}} needs {n} devices, have "
                         f"{world} (one process a device: start {n} with "
                         f"torchrun --nproc_per_node {n})")
    return Mesh("data", n, rank)


def local_mesh(data_axis: str = "data") -> Mesh:
    """Every rank of the job on one data axis (the JAX ``local_mesh``)."""
    _refuse_axes({data_axis: 1})
    return make_mesh({data_axis: -1})


def axis_group(axis_name: str):
    """(process group, size) of the mesh axis ``axis_name``: the job's
    default group and its size, or (None, 1) in a single process."""
    _refuse_axes({axis_name: 1})
    dist = _dist()
    if not dist.is_initialized():
        return None, 1
    return None, dist.get_world_size()
