"""The data-parallel cases that tests/test_torch_data_parallel.py and
tests/test_torch_grad_comm.py run in 2 and 4 gloo ranks (through
``bigdl_tpu_torch.parallel.launch.spawn``), and the models they
share with the tests' single-process runs. It imports torch and the port
only: each rank is a fresh process, and no rank imports jax.

Every case reads its inputs from ``inputs.npz`` (written by the test,
which makes them from seeds with numpy, or from JAX init trees) and
writes ``<case>_r<rank>.npz`` beside it; it returns a small JSON-able dict.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.optim import (LAMB, LARS, SGD, Adam, Optimizer,
                                   Top1Accuracy, Top5Accuracy, Trigger,
                                   Validator)

MLP_ITERS = 10
LM = dict(vocab=61, d_model=32, num_layers=2, num_heads=4, max_len=32)
CONV_STEPS = 50


# ---------------------------------------------------------------- models
def blob_data(n=64):
    rs = np.random.RandomState(0)
    x = (rs.rand(n, 2) * 2 - 1).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int32)
    return x, y


def mlp():
    """The JAX package's DP test model (tests/test_parallel.py)."""
    return Sequential(nn.Linear(2, 8), nn.Tanh(), nn.Linear(8, 2),
                      nn.LogSoftMax())


def deep_mlp():
    g = torch.Generator().manual_seed(3)
    return Sequential(nn.Linear(4, 16, generator=g), nn.Tanh(),
                      nn.Linear(16, 24, generator=g), nn.Tanh(),
                      nn.Linear(24, 3, generator=g), nn.LogSoftMax())


def dropout_mlp():
    g = torch.Generator().manual_seed(5)
    return Sequential(nn.Linear(8, 32, generator=g), nn.Dropout(0.5),
                      nn.Linear(32, 4, generator=g), nn.LogSoftMax())


def lm():
    return models.TransformerLM(LM["vocab"], d_model=LM["d_model"],
                                num_layers=LM["num_layers"],
                                num_heads=LM["num_heads"],
                                max_len=LM["max_len"], attn_impl="flash",
                                pos_encoding="rope", num_kv_heads=2)


def methods():
    return {"sgd": lambda: SGD(0.1, momentum=0.9, weight_decay=1e-3),
            "adam": lambda: Adam(1e-2),
            "lars": lambda: LARS(0.1, weight_decay=1e-3),
            "lamb": lambda: LAMB(1e-2, weight_decay=1e-2)}


def load(model, inp, prefix):
    """Load ``prefix/<name>`` arrays of ``inp`` into ``model`` (strictly)."""
    sd = {k[len(prefix) + 1:]: torch.from_numpy(np.array(inp[k]))
          for k in inp.files if k.startswith(prefix + "/")}
    model.load_state_dict(sd, strict=True)
    return model


def params_np(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def train(model, x, y, batch, method, iters, strategy=None, crit=None,
          **kw):
    """``iters`` Optimizer steps over BatchDataSet(x, y, batch) in order;
    returns the trained model and each step's loss (as the criterion saw
    it: this rank's part under a strategy)."""
    crit = crit or nn.ClassNLLCriterion()
    losses = []

    def recording(out, target):
        loss = crit(out, target)
        losses.append(float(loss.detach()))
        return loss

    opt = Optimizer(model, BatchDataSet(x, y, batch), recording,
                    optim_method=method, end_when=Trigger.max_iteration(iters),
                    strategy=strategy, device="cpu", **kw)
    opt.optimize()
    return model, losses


def manual_steps(model, x, y, method, steps, strategy=None):
    """Steps of the parts a strategy exposes (place, shard_batch,
    reduce_grads, update) without the Optimizer; returns (params, the
    optimizer state this rank keeps, losses)."""
    crit = nn.ClassNLLCriterion()
    params = dict(model.named_parameters())
    state = method.init(params)
    if strategy is not None:
        params, _, state = strategy.place(params, {}, state)
    losses = []
    for _ in range(steps):
        xs, ys = (x, y) if strategy is None else strategy.shard_batch(x, y)
        loss = crit(model(torch.from_numpy(xs)), torch.from_numpy(ys))
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        if strategy is None:
            method.update(grads, state, params)
        else:
            grads, loss = strategy.reduce_grads(grads, loss)
            strategy.update(method, grads, state, params)
        losses.append(float(loss.detach()))
    return params, state, losses


def conv_problem():
    """The JAX convergence test's regression problem (tests/
    test_grad_comm.py TestConvergence): a tanh MLP on 64 rows."""
    rs = np.random.RandomState(0)
    w1 = (rs.randn(8, 16) * 0.3).astype(np.float32)
    w2 = (rs.randn(16, 1) * 0.3).astype(np.float32)
    x = rs.randn(64, 8).astype(np.float32)
    y = np.sin(x.sum(axis=1, keepdims=True)).astype(np.float32)
    return {"w1": w1, "b1": np.zeros(16, np.float32), "w2": w2}, x, y


def conv_train(compress, steps=CONV_STEPS, strategy=None):
    """``steps`` plain SGD(0.1) steps of the convergence problem with the
    gradients through ``strategy.reduce_grads``; the last loss."""
    init, x, y = conv_problem()
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in init.items()}
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    if strategy is not None:
        xs, ys = strategy.shard_batch(xs, ys)
    loss = None
    for _ in range(steps):
        h = torch.tanh(xs @ p["w1"] + p["b1"])
        loss = torch.mean((h @ p["w2"] - ys) ** 2)
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if strategy is not None:
            g, loss = strategy.reduce_grads(g, loss)
        with torch.no_grad():
            for k in p:
                p[k].sub_(0.1 * g[k])
    return float(loss.detach())


# ---------------------------------------------------------------- cases
def _strategy(**kw):
    from bigdl_tpu_torch.parallel import DataParallel
    return DataParallel(**kw)


def case_mlp(rank, world, inp, out):
    x, y = blob_data()
    model = load(mlp(), inp, "mlp")
    train(model, x, y, 64, SGD(0.5, momentum=0.9), MLP_ITERS, _strategy())
    np.savez(out, **params_np(model))
    return {}


def case_zero1(rank, world, inp, out):
    rs = np.random.RandomState(7)
    x = rs.randn(16, 4).astype(np.float32)
    y = rs.randint(0, 3, 16).astype(np.int32)
    res, arrays = {}, {}
    for name, make in methods().items():
        for zero1 in (True, False):
            strat = _strategy(zero1=zero1)
            params, state, _ = manual_steps(deep_mlp(), x, y, make(), 5,
                                            strat)
            tag = f"{name}_{int(zero1)}"
            for k, v in params.items():
                arrays[f"{tag}/{k}"] = v.detach().numpy().copy()
            per = {k: sorted(v) for k, v in state.items()
                   if isinstance(v, dict)}
            res[tag] = {"state": per,
                        "owned": sorted(n for n in params
                                        if strat.owner(n) == rank)}
    np.savez(out, **arrays)
    return res


def case_bn(rank, world, inp, out):
    x, dy = inp["bn/x"], inp["bn/dy"]
    per = len(x) // world
    rows = slice(rank * per, (rank + 1) * per)
    arrays = {}
    for mode in ("off", "stats", "apply"):
        for relu in (False, True):
            bn = nn.BatchNormalization(x.shape[-1], axis_name="data",
                                       fused=False if mode == "off" else mode)
            bn.fuse_relu = relu
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(inp["bn/gamma"]))
                bn.bias.copy_(torch.from_numpy(inp["bn/beta"]))
            xt = torch.from_numpy(x[rows]).requires_grad_(True)
            yt = bn.train()(xt)
            (yt * torch.from_numpy(dy[rows])).sum().backward()
            tag = f"{mode}_{int(relu)}"
            arrays.update({f"{tag}/y": yt.detach().numpy(),
                           f"{tag}/dx": xt.grad.numpy(),
                           f"{tag}/dgamma": bn.weight.grad.numpy(),
                           f"{tag}/dbeta": bn.bias.grad.numpy(),
                           f"{tag}/running_mean": bn.running_mean.numpy(),
                           f"{tag}/running_var": bn.running_var.numpy()})
    np.savez(out, **arrays)
    return {}


def case_cifar(rank, world, inp, out):
    x, y = inp["cifar_x"], inp["cifar_y"]
    model = load(models.resnet_cifar(8, fused_bn="apply"), inp, "cifar")
    _, losses = train(model, x, y, len(x) // 3,
                      SGD(0.1, momentum=0.9), 3, _strategy())
    np.savez(out, **params_np(model))
    return {"losses": losses}


def case_lm(rank, world, inp, out):
    from bigdl_tpu_torch.nn import TimeDistributedCriterion
    x, y = inp["lm_x"], inp["lm_y"]
    model = load(lm(), inp, "lm")
    _, losses = train(model, x, y, len(x) // 2, SGD(0.1, momentum=0.9), 2,
                      _strategy(),
                      crit=TimeDistributedCriterion(nn.ClassNLLCriterion()))
    np.savez(out, **params_np(model))
    return {"losses": losses}


def case_dropout(rank, world, inp, out):
    x, y = inp["drop/x"], inp["drop/y"]
    model, losses = train(dropout_mlp(), x, y, len(x), SGD(0.1), 3,
                          _strategy(), seed=11)
    np.savez(out, **params_np(model))
    return {"losses": losses}


def case_validator(rank, world, inp, out):
    rs = np.random.RandomState(9)
    x = rs.randn(23, 4).astype(np.float32)
    y = rs.randint(0, 3, 23).astype(np.int32)
    res = Validator(deep_mlp(), BatchDataSet(x, y, 10, drop_remainder=False),
                    "cpu", strategy=_strategy()).test(
        [Top1Accuracy(), Top5Accuracy()])
    np.savez(out)
    return {"results": [list(r.result()) for r in res]}


def case_ckpt(rank, world, inp, out):
    """Resume the JAX package's dp checkpoint at ``inp['ckpt/jax']`` to
    iteration 4, and write the port's own at iterations 2 and 4 under
    ``inp['ckpt/port']`` from the same start."""
    x, y = blob_data()
    jdir, pdir = str(inp["ckpt/jax"]), str(inp["ckpt/port"])
    model = load(mlp(), inp, "mlp")
    opt = Optimizer(model, BatchDataSet(x, y, 16), nn.ClassNLLCriterion(),
                    optim_method=SGD(0.5, momentum=0.9),
                    end_when=Trigger.max_iteration(4), strategy=_strategy(),
                    device="cpu")
    opt.resume(jdir).optimize()
    resumed = params_np(model)
    model = load(mlp(), inp, "mlp")
    opt = Optimizer(model, BatchDataSet(x, y, 16), nn.ClassNLLCriterion(),
                    optim_method=SGD(0.5, momentum=0.9),
                    end_when=Trigger.max_iteration(4), strategy=_strategy(),
                    device="cpu")
    opt.set_checkpoint(Trigger.several_iteration(2), pdir)
    opt.optimize()
    np.savez(out, **{f"resumed/{k}": v for k, v in resumed.items()},
             **{f"port/{k}": v for k, v in params_np(model).items()})
    return {"files": sorted(os.listdir(pdir))}


def case_conv(rank, world, inp, out):
    from bigdl_tpu_torch.parallel import (compressed_psum, local_mesh,
                                          make_grad_comm_config)
    bucket = torch.tensor([1.0, -2.5, 70000.0, 1e-3]) * (rank + 1)
    res = {"psum": {m: compressed_psum(bucket, local_mesh(), "data",
                                       m).tolist() for m in ("bf16", "fp16")}}
    for mode in ("off", "bf16", "fp16", "bf16+ec"):
        strat = _strategy(grad_comm=make_grad_comm_config(mode, "auto"))
        res[mode] = conv_train(mode, strategy=strat)
        res[f"{mode}_info"] = strat.grad_comm_info()
    np.savez(out)
    return res


def case_perf(rank, world, inp, out):
    from bigdl_tpu_torch.cli import perf
    res = {}
    for mode in (None, "off", "bf16"):
        line = perf.run("resnet20_cifar", batch=4, iterations=1, warmup=1,
                        dtype=torch.float32, device="cpu", strategy="dp",
                        grad_compress=mode, fused_bn="apply")
        res[str(mode)] = {k: line[k] for k in (
            "strategy", "n_devices", "mesh", "grad_compress",
            "grad_buckets", "grad_comm", "losses", "batch")
            if k in line}
    np.savez(out)
    return res


def run_all(args: dict) -> dict:
    """The launch target: every case of ``args['cases']`` on this rank."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    inp = np.load(args["inputs"], allow_pickle=False)
    res = {}
    for name in args["cases"]:
        out = os.path.join(args["out"], f"{name}_r{rank}.npz")
        res[name] = globals()[f"case_{name}"](rank, world, inp, out)
    return res


def case_cli(rank, world, inp, out):
    """The CLI surface at 2 ranks: build_strategy's config and exits, and
    cli.transformerlm trained with --strategy dp."""
    import argparse

    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.cli import transformerlm as lm_cli

    def args(**kw):
        ns = argparse.Namespace(strategy="dp", dataParallel=False,
                                stepsPerDispatch=1, gradCompress="off",
                                gradBuckets="auto", platform="cpu")
        for k, v in kw.items():
            setattr(ns, k, v)
        return ns

    res = {}
    s = common.build_strategy(args(gradCompress="bf16+ec", gradBuckets="2"))
    res["threaded"] = [s.grad_comm.compress, s.grad_comm.bucket_bytes,
                       s.world]
    res["off"] = common.build_strategy(args()).grad_comm is None
    res["alias"] = type(common.build_strategy(
        args(strategy=None, dataParallel=True))).__name__
    for tag, kw in (("dispatch", dict(stepsPerDispatch=2)),
                    ("inner", dict(innerSteps=2))):
        try:
            common.build_strategy(args(**kw))
        except SystemExit as e:
            res[tag] = str(e)
    try:
        common.build_strategy(args(), batch=3)
    except SystemExit as e:
        res["batch"] = str(e)
    folder = str(inp["cli/folder"])
    trained = lm_cli.main(["train", "-f", folder, "--platform", "cpu",
                           "--dModel", "16", "--numLayers", "1",
                           "--numHeads", "2", "--seqLength", "16", "-b", "4",
                           "--maxEpoch", "1", "--vocabSize", "40",
                           "--strategy", "dp", "--logEvery", "1"])
    np.savez(out, **params_np(trained.module))
    return res


def hang(args):
    """A rank that never finishes (spawn's time limit must end it)."""
    import time
    time.sleep(600)


def rank1_fails(args):
    """Rank 1 fails while rank 0 waits for it at a barrier."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
    return {}
