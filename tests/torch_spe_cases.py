"""The sequence, pipeline and expert-parallel cases that
tests/test_torch_sequence_parallel.py, tests/test_torch_pipeline.py and
tests/test_torch_expert_parallel.py run in gloo ranks (one job a file,
through ``bigdl_tpu_torch.parallel.launch.spawn``). It imports torch and
the port only: each rank is a fresh process, and no rank imports jax.

Every case reads its inputs from ``inputs.npz`` in ``args["dir"]`` and
writes ``<case>_r<rank>.npz`` beside it; ``run_all`` returns each case's
JSON-able notes (the texts of the exits it provoked).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.optim import SGD

# ring attention: (seq ranks, causal, segments, block_k) over (2, 2, 16, 8)
# q/k/v; s_local is 8 at 2 ranks and 4 at 4, so block_k 2 divides it and 3
# does not
RING_CASES = [(n, causal, seg, bk) for n in (2, 4)
              for causal, seg, bk in ((True, False, 2), (True, True, 3),
                                      (False, False, 3), (False, True, 2))]
RING_SHAPE = (2, 2, 16, 8)
# the sp LM: its geometry, and the mesh each position encoding runs on
SP_LM = dict(vocab=32, d_model=16, num_layers=2, num_heads=4, max_len=16)
SP_MESH = {"sinusoidal": {"data": 2, "seq": 2},
           "rope": {"data": 1, "seq": 4}}
SP_BATCH, SP_LR = 4, 0.1
# the perf row of the sp, pp and ep lines (small; the vocab is the zoo's)
PERF_LM = dict(d_model=32, num_layers=2, num_heads=4, max_len=16,
               pos_encoding="rope", num_kv_heads=2)
# the pipeline: L blocks of TransformerEncoderLayer(D, 2, 2D) on (B, S, D)
PIPE_L, PIPE_D, PIPE_B, PIPE_S = 4, 8, 8, 5
PIPE_FWD = [("p2_m2", 2, None), ("p2_m4", 4, None), ("p2d2_m2", 2, "data")]
PIPE_LR = 0.1
# the MoE: E experts Linear(D, H), ReLU, Linear(H, D)
MOE_E, MOE_D, MOE_H = 4, 8, 16
MOE_CASES = {"top2": dict(top_k=2, capacity_factor=2.0),
             "top1": dict(top_k=1, capacity_factor=1.25),
             "dense": dict(dense=True)}
MOE_LR, MOE_AUX = 0.1, 0.01
# the cli.perf harness: the transformer_lm row's geometry at a short seq
HARNESS = dict(model="transformer_lm", batch=2, seq=8, steps=3)


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def _load(model, inp, prefix):
    """``model`` with the ``prefix/``-keyed arrays of ``inp`` (an npz or a
    dict) loaded strictly."""
    keys = getattr(inp, "files", None) or list(inp)
    model.load_state_dict({k[len(prefix) + 1:]: torch.from_numpy(
        np.array(inp[k])) for k in keys if k.startswith(prefix + "/")},
        strict=True)
    return model


def _exit_text(fn) -> str:
    try:
        fn()
    except (SystemExit, ValueError) as e:
        return str(e)
    return ""


# ----------------------------------------------------------------- sp
def ring_tag(n, causal, seg, bk) -> str:
    return f"n{n}_{'c' if causal else 'f'}_{'s' if seg else 'x'}_b{bk}"


def case_ring(args, inp):
    """Each ring case on a {"data": 4 / n, "seq": n} mesh: this rank's
    output chunk and its dq, dk, dv of the output's sum."""
    from bigdl_tpu_torch.parallel import make_mesh, make_ring_attention
    out = {}
    q, k, v = (torch.from_numpy(inp[f"ring_{t}"]) for t in "qkv")
    segs = torch.from_numpy(inp["ring_seg"])
    world = 4
    for n, causal, seg, bk in RING_CASES:
        mesh = make_mesh({"data": world // n, "seq": n})
        line = mesh.axis_view("seq")
        s = q.shape[2] // n
        cut = slice(line.rank * s, (line.rank + 1) * s)
        parts = [t[:, :, cut].clone().requires_grad_() for t in (q, k, v)]
        attn = make_ring_attention(mesh, "seq", batch_axis="data",
                                   block_k=bk)
        o = attn(*parts, causal=causal,
                 segments=segs[:, cut] if seg else None)
        o.sum().backward()
        tag = ring_tag(n, causal, seg, bk)
        out[f"{tag}/o"] = o.detach().numpy()
        for name, t in zip(("dq", "dk", "dv"), parts):
            out[f"{tag}/{name}"] = t.grad.numpy()
    return out


def sp_lm(pos, attn_impl=None):
    return models.TransformerLM(
        SP_LM["vocab"], d_model=SP_LM["d_model"],
        num_layers=SP_LM["num_layers"], num_heads=SP_LM["num_heads"],
        max_len=SP_LM["max_len"], pos_encoding=pos, attn_impl=attn_impl)


def sp_step(model, x, y, strategy=None):
    """One SGD(SP_LR, momentum 0.9) step of ``model`` on (x, y) (this
    rank's block under ``strategy``); returns (loss, whole params)."""
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    opt = SGD(SP_LR, momentum=0.9)
    params = dict(model.named_parameters())
    state = opt.init(params)
    if strategy is not None:
        params, _, state = strategy.bind(model).place(params, None, state)
        x, y = strategy.shard_batch(x, y)
    loss = crit(model(x), y)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    if strategy is None:
        opt.update(grads, state, params)
    else:
        grads, loss = strategy.reduce_grads(grads, loss)
        strategy.update(opt, grads, state, params)
    return float(loss.detach()), {k: v.detach().numpy().copy()
                         for k, v in params.items()}


def case_sp_lm(args, inp):
    """One step of the 2-layer LM under ``SequenceParallel`` with the ring
    (sinusoidal at dp:2 x sp:2, RoPE at sp:4); batch norm over the seq
    axis of {"data": 2, "seq": 2} on this rank's (b, s_local, c) chunk."""
    from bigdl_tpu_torch.parallel import (SequenceParallel, make_mesh,
                                          make_ring_attention)
    out = {}
    x, y = (torch.from_numpy(inp[f"lm_{t}"]) for t in "xy")
    for pos, axes in SP_MESH.items():
        mesh = make_mesh(axes)
        ring = make_ring_attention(mesh, "seq", batch_axis="data",
                                   block_k=4)
        model = _load(sp_lm(pos, ring), inp, f"lm_{pos}")
        loss, params = sp_step(model, x, y, SequenceParallel(mesh))
        out[f"{pos}/loss"] = np.asarray(loss)
        out.update({f"{pos}/{k}": v for k, v in params.items()})
    mesh = make_mesh({"data": 2, "seq": 2})
    rows, cols = mesh.axis_view("data"), mesh.axis_view("seq")
    bx = torch.from_numpy(inp["bn_x"])
    b, s = bx.shape[0] // 2, bx.shape[1] // 2
    part = bx[rows.rank * b:(rows.rank + 1) * b,
              cols.rank * s:(cols.rank + 1) * s]
    bn = nn.BatchNormalization(bx.shape[-1], axis_name="seq").train()
    out["bn/y"] = bn(part).detach().numpy()
    out["bn/running_var"] = bn.running_var.numpy()
    return out


def case_sp_perf(args, inp):
    """``cli.perf --strategy sp`` (dp:2 x sp:2) on the small row, and its
    exits: a length the seq axis does not divide, a model that is no LM,
    ``--remat``."""
    from bigdl_tpu_torch.cli import perf
    perf.LM_CONFIGS["spe_test_lm"] = dict(PERF_LM)
    line = perf.run("spe_test_lm", batch=4, iterations=2, warmup=1,
                    dtype=torch.float32, device="cpu", seq_len=16,
                    strategy="sp")
    notes = {k: line[k] for k in ("strategy", "mesh", "n_devices")}
    notes["odd_seq"] = _exit_text(lambda: perf.run(
        "spe_test_lm", batch=4, iterations=1, warmup=1, dtype=torch.float32,
        device="cpu", seq_len=15, strategy="sp"))
    notes["not_lm"] = _exit_text(lambda: perf.run(
        "lenet5", batch=4, iterations=1, warmup=1, dtype=torch.float32,
        device="cpu", strategy="sp"))
    notes["remat"] = _exit_text(lambda: perf.run(
        "spe_test_lm", batch=4, iterations=1, warmup=1, dtype=torch.float32,
        device="cpu", seq_len=16, strategy="sp", remat="full"))
    return {"losses": np.asarray(line["losses"])}, notes


# ----------------------------------------------------------------- pp
def pipe_stack():
    from bigdl_tpu_torch.parallel import PipelineStack
    return PipelineStack(nn.TransformerEncoderLayer(PIPE_D, 2, 2 * PIPE_D),
                         PIPE_L)


def case_pipe(args, inp):
    """On {"pipe": 2, "data": 2}: ``pipeline_forward`` per PIPE_FWD (with
    the rows each rank returns), one ``make_pipeline_train_step`` step
    (micro 2, data_axis "data") with this stage's parameters after it, and
    the exits of a stack the stages do not divide and of a batch the
    microbatches do not divide."""
    from bigdl_tpu_torch.parallel import (make_mesh, make_pipeline_train_step,
                                          pipeline_forward,
                                          place_pipeline_params)
    from bigdl_tpu_torch.parallel.pipeline import pipeline_rows
    out = {}
    x, y = (torch.from_numpy(inp[f"pipe_{t}"]) for t in "xy")
    mesh = make_mesh({"pipe": 2, "data": 2})
    stack = place_pipeline_params(_load(pipe_stack(), inp, "stack"), mesh)
    with torch.no_grad():
        for tag, micro, data in PIPE_FWD:
            out[f"fwd_{tag}"] = pipeline_forward(
                stack, mesh, x, micro, data_axis=data).numpy()
            out[f"rows_{tag}"] = pipeline_rows(len(x), micro, mesh,
                                               data).numpy()
    stack = place_pipeline_params(_load(pipe_stack(), inp, "stack"), mesh)
    opt = SGD(PIPE_LR, momentum=0.9)
    state = opt.init(dict(stack.named_parameters()))
    step = make_pipeline_train_step(stack, mesh, nn.MSECriterion(), opt, 2,
                                    axis="pipe", data_axis="data")
    out["train/loss"] = step(state, x, y).numpy()
    out.update({f"train/{k}": v.detach().numpy()
                for k, v in stack.named_parameters()})
    out["train/stage"] = np.asarray(stack.stage)
    from bigdl_tpu_torch.parallel import PipelineStack
    notes = {
        "blocks": _exit_text(lambda: place_pipeline_params(PipelineStack(
            nn.TransformerEncoderLayer(PIPE_D, 2), 3), mesh)),
        "batch": _exit_text(lambda: pipeline_forward(stack, mesh, x[:5],
                                                     2))}
    return out, notes


# ----------------------------------------------------------------- ep
def moe(case):
    return nn.MoE(lambda: Sequential(nn.Linear(MOE_D, MOE_H), nn.ReLU(),
                                     nn.Linear(MOE_H, MOE_D)),
                  MOE_E, MOE_D, **MOE_CASES[case])


def moe_step(model, x, y):
    """One SGD(MOE_LR, momentum 0.9) step of MSE + MOE_AUX x the auxiliary
    loss; returns (loss, params)."""
    from bigdl_tpu_torch.nn.moe import collect_aux_losses
    opt = SGD(MOE_LR, momentum=0.9)
    params = dict(model.named_parameters())
    state = opt.init(params)
    with collect_aux_losses() as aux:
        out = model(x)
    loss = nn.MSECriterion()(out, y) + MOE_AUX * sum(aux)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt.update(dict(zip(params, grads)), state, params)
    return float(loss), {k: v.detach().numpy().copy()
                         for k, v in params.items()}


def case_ep(args, inp):
    """Each MOE_CASES MoE placed over {"expert": 2}: the loss of one step
    and this rank's parameters after it (its experts' stage too)."""
    from bigdl_tpu_torch.parallel import make_mesh
    out = {}
    mesh = make_mesh({"expert": 2})
    x, y = (torch.from_numpy(inp[f"moe_{t}"]) for t in "xy")
    for case in MOE_CASES:
        m = _load(moe(case), inp, f"moe_{case}").place_expert_parallel(mesh)
        loss, params = moe_step(m, x, y)
        out[f"{case}/loss"] = np.asarray(loss)
        out[f"{case}/stage"] = np.asarray(m.experts.stage)
        out.update({f"{case}/{k}": v for k, v in params.items()})
    return out


def case_harness(args, inp):
    """``cli.perf``'s pp and ep harness at HARNESS geometry from the JAX
    harness's weights (``inputs.npz`` "pp/...", "ep/..."): each step's
    loss; then ``cli.perf.run`` at pp and ep for the line, and the
    ``--gradCompress`` exits."""
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.parallel import make_mesh
    out, notes = {}, {}
    h = HARNESS
    for name, axes in (("pp", {"pipe": 2, "data": 1}), ("ep", {"expert": 2})):
        init = {k[len(name) + 1:]: torch.from_numpy(np.array(inp[k]))
                for k in inp.files if k.startswith(name + "/")}
        setup = perf._setup_strategy_harness(
            name, h["model"], h["batch"], make_mesh(axes), axes,
            torch.float32, h["seq"], "cpu", init=init)
        out[f"{name}/losses"] = np.asarray(
            [float(setup["step"]()) for _ in range(h["steps"])])
        line = perf.run(h["model"], batch=h["batch"], iterations=1,
                        warmup=1, dtype=torch.float32, device="cpu",
                        seq_len=h["seq"], strategy=name)
        notes[name] = {k: line[k] for k in ("strategy", "mesh",
                                            "n_devices")}
        notes[name]["finite"] = bool(np.isfinite(line["final_loss"]))
        notes[f"{name}_compress"] = _exit_text(lambda: perf.run(
            h["model"], batch=h["batch"], iterations=1, warmup=1,
            dtype=torch.float32, device="cpu", seq_len=h["seq"],
            strategy=name, grad_compress="bf16"))
    return out, notes


CASES = {"ring": case_ring, "sp_lm": case_sp_lm, "sp_perf": case_sp_perf,
         "pipe": case_pipe, "ep": case_ep, "harness": case_harness}


def run_all(args):
    """Each case in ``args["cases"]``, writing ``<case>_r<rank>.npz``;
    returns {case: notes}."""
    torch.set_num_threads(1)
    rank = _rank()
    inp = np.load(os.path.join(args["dir"], "inputs.npz"))
    info = {}
    for name in args["cases"]:
        got = CASES[name](args, inp)
        got, notes = got if isinstance(got, tuple) else (got, {})
        info[name] = notes
        np.savez(os.path.join(args["dir"], f"{name}_r{rank}.npz"), **got)
    return info
