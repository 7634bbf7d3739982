"""The gloo-rank cases of tests/test_torch_resilience.py (run through
``bigdl_tpu_torch.parallel.launch.spawn``) and the model they share with
the test's single-process runs. It imports torch and the port only: each
rank is a fresh process, and no rank imports jax."""

from __future__ import annotations

import os

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger


def model():
    g = torch.Generator().manual_seed(2)
    return Sequential(nn.Linear(8, 16, generator=g), nn.Tanh(),
                      nn.Linear(16, 24, generator=g), nn.Tanh(),
                      nn.Linear(24, 3, generator=g), nn.LogSoftMax())


def method():
    return SGD(learning_rate=0.1, momentum=0.9)


def optimizer(strategy, iters, ckpt=None, sharded=False):
    rs = np.random.RandomState(0)
    x = rs.randn(64, 8).astype(np.float32)
    y = rs.randint(0, 3, 64).astype(np.int32)
    opt = Optimizer(model(), BatchDataSet(x, y, 16), nn.ClassNLLCriterion(),
                    optim_method=method(),
                    end_when=Trigger.max_iteration(iters), seed=7,
                    log_every=100, strategy=strategy, device="cpu")
    if ckpt:
        opt.set_checkpoint(Trigger.several_iteration(4), ckpt,
                           sharded=sharded)
    return opt


def zero1_dcp(args: dict) -> dict:
    """Two ZeRO-1 runs of 4 steps at this job's ranks, one checkpointing
    DCP snapshots into ``dir/dcp``, one blobs into ``dir/blob``."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import DataParallel, make_mesh

    torch.set_num_threads(1)
    world = dist.get_world_size()
    for d, sharded in (("dcp", True), ("blob", False)):
        strat = DataParallel(make_mesh({"data": world}))
        optimizer(strat, 4, os.path.join(args["dir"], d),
                  sharded).optimize()
    return {"world": world}
