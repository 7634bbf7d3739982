"""The gloo-rank case of tests/test_torch_elastic.py (run through
``bigdl_tpu_torch.parallel.launch.spawn`` at 4 ranks): first a
``--minDevices 4`` run that gives up when a rank is lost, then
``cli.common.run_optimize`` under ``--elastic hold`` losing rank 3 before
step 5. It imports torch and the port only: each rank is a fresh process,
and no rank imports jax."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

ITERS = 10


def model():
    return Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 3),
                      nn.LogSoftMax())


def data():
    rs = np.random.RandomState(0)
    return (rs.randn(64, 8).astype(np.float32),
            rs.randint(0, 3, 64).astype(np.int32))


def run_all(a: dict) -> dict:
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.resilience import elastic, faults

    torch.set_num_threads(1)
    rank = dist.get_rank()
    inp = np.load(a["inputs"])
    x, y = data()
    out = {"rank": rank, "world": dist.get_world_size()}
    sups = []

    class Recorded(elastic.ElasticSupervisor):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            sups.append(self)

    elastic.ElasticSupervisor = Recorded

    def args_for(ckpt, min_devices):
        return SimpleNamespace(strategy="dp", dataParallel=False,
                               elastic="hold", minDevices=min_devices,
                               platform="cpu", checkpoint=ckpt, seed=7,
                               supervise=None, gradCompress="off",
                               gradBuckets="auto", stepsPerDispatch=1)

    def make(args, summary):
        def build():
            strat = common.build_strategy(args)
            m = model()
            m.load_state_dict({k[2:]: torch.from_numpy(inp[k])
                               for k in inp.files if k.startswith("p/")})
            opt = Optimizer(m, BatchDataSet(x, y, 16),
                            nn.ClassNLLCriterion(),
                            optim_method=SGD(learning_rate=0.1),
                            end_when=Trigger.max_iteration(ITERS), seed=7,
                            log_every=1, strategy=strat, device="cpu")
            opt.set_checkpoint(Trigger.several_iteration(3), args.checkpoint)
            if summary:
                opt.set_summary(summary)
            return opt
        return build

    # (1) below --minDevices: every rank exits with the elastic message
    faults.install_plan(faults.parse_plan("kill_device@step:2:1"))
    args = args_for(os.path.join(a["dir"], "ck_min"), 4)
    try:
        common.run_optimize(make(args, None), args)
        out["gave_up"] = None
    except SystemExit as e:
        out["gave_up"] = str(e.code)
    faults.clear_plan()

    # (2) --elastic hold: rank 3 is lost before step 5 and leaves the job
    faults.install_plan(faults.parse_plan("kill_device@step:5:1"))
    args = args_for(os.path.join(a["dir"], "ck"), 2)
    summary = os.path.join(a["dir"], f"sum_r{rank}")
    trained = common.run_optimize(make(args, summary), args)
    out["healthy"] = faults.healthy_devices()
    out["reshapes"] = sups[-1].reshapes
    out["annotation_reshapes"] = sups[-1].annotation()["reshapes"]
    out["events"] = faults.injected_events()
    with open(os.path.join(summary, "train.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    out["losses"] = {r["iteration"]: r["loss"] for r in rows}
    out["params"] = {k: v.numpy().tolist()
                     for k, v in trained.params.items()}
    return out
