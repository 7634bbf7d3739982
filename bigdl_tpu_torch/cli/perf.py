"""Training throughput of the perf model zoo's image and LM rows
(counterpart of ``bigdl_tpu/cli/perf.py``; its default row is
``inception_v1``, as the JAX harness's)::

    python -m bigdl_tpu_torch.cli.perf [-m inception_v1] [-b 32]
    python -m bigdl_tpu_torch.cli.perf -m resnet50_fba -b 128 --dataType random
    python -m bigdl_tpu_torch.cli.perf -m transformer_lm_1k_hd128 -b 8
    python -m bigdl_tpu_torch.cli.perf -m transformer_lm_16k -b 1
    python -m bigdl_tpu_torch.cli.perf -m vit_b16 -b 64 --innerSteps 4
    python -m bigdl_tpu_torch.cli.perf -m resnet20_cifar --timeToAcc 0.9 \\
        --imageSize 32 [--ttaHard] [--valEvery N]

builds the model with random weights from a seed (the BN kernels for the
``_fbn``/``_fba`` rows or ``--fusedBN``, the flash kernels for attention),
takes SGD(0.01, momentum 0.9) steps over one resident batch from
``np.random.RandomState(0)`` (images of ones or N(0, 1) per
``--dataType``, random labels; random tokens for an LM), and prints one
JSON line: model, batch, iterations, seconds, records_per_second (images
or sequences a second), tokens_per_second (LM rows), dtype, fused_bn,
inner_steps. Warm-up steps run before the timed ones; the clock stops
after the last step's loss reaches the host. ``--innerSteps K`` (K > 1)
makes each iteration K steps replayed as one CUDA graph, the counterpart
of the JAX harness's K-step ``fori_loop`` on the resident batch; the
rates are over iterations x K steps. bf16 activations unless ``--f32``
(images are cast to bf16, the parameters stay f32); the loss is taken on
the f32 output. The long-context rows carry their remat
(``transformer_lm_16k`` "dots", ``_32k`` "full") unless ``--remat``
names another; the ViT rows (``vit_b16``, ``vit_s16``: 224 x 224 x 3,
1000 classes) and every LM row run the flash kernels, where the JAX
harness takes them on its TPU only.

MFU: ``mfu`` = the step's analytic FLOPs (``utils/flops.py``: matmul and
conv FLOPs of one forward, loss and backward, counted on fake tensors
with the JAX package's rules, so both packages give one number) x steps
/ seconds / the card's dense bf16 peak (:func:`peak_flops`: NVIDIA's
H100 datasheet figures matched against the device name, a nominal 1e12
on the CPU, and an ``UNMATCHED(name)`` label with 1e12 elsewhere, so a
fallback shows). ``step_gflops_hlo`` is null: the port has no compiler
count to cross-check with.

``--convLayout``/``--convGeom`` install the conv layout policy for the
run (``ops/conv2d.py``; the line then carries ``conv_layouts`` and
``conv_geom``). ``--autotune cached|measure`` runs under the tuner's
decisions (``tuning/``: the conv layouts, the BN kernels' slab heights,
the key-padding block, the bucket bound), and the line's ``autotune``
names the mode and each key the run consulted with its decision or
"default". ``--profile DIR`` writes a ``torch.profiler`` trace of the
timed loop to ``DIR/trace.json``. ``--lint[=strict]`` lints the run's
configuration first (``analysis.lint_config``: the traced step on fake
tensors, and under ``--strategy`` rank 0's sharded step; nothing
launched): the line carries the summary as ``lint`` (with the vetted
``mesh``), and strict exits 2 on an error finding before the run.

``--obs`` (``--traceDir``, ``--traceSteps N@M``, ``--metricsPort``: the
JAX harness's observability flags) runs the timed loop with each
dispatch metered into its phases and a wait for the card after it, and
fills the line's ``data_wait_s`` ... ``stall_frac``, ``hbm_peak_bytes``,
``hbm_headroom_frac``, ``mem`` and ``obs`` (and, after a capture window,
``attrib``, ``collective_s`` and ``collective_frac``); without it those
columns are null and the loop is the plain one. A device OOM in the
warm-up writes ``<traceDir>/memory_report.json`` before it propagates.

``--timeToAcc T`` runs the time-to-accuracy harness instead
(:func:`run_time_to_acc`): synthetic learnable JPEGs written from a seed
(or real shards under ``--data record:DIR``, with ``train/`` and
``val/``), record shards, ``RecordImageDataSet`` decode and augment,
SGD(0.1, momentum 0.9, ``--ttaWd``) until top-1 reaches T or
``--maxEpoch``, and the first crossing's wall-clock time from the
validation curve.

``--data record:DIR`` (image rows) feeds every step a fresh batch from
the record shards of DIR instead of the resident batch, as the JAX
harness does: JPEG decode, a random crop of the model's input size from a
resize of its short side (256 for 224), a flip and the ImageNet mean and
std, per sample, then the copy to the card, all inside the timed loop
(one step a dispatch; ``--innerSteps`` is ignored there, as in the JAX
harness). With ``--dataWorkers N`` or ``--stage host|device`` the
pipeline's executor and staging thread feed it (``pipeline`` in the JSON
line records the choices and the plan), else the record set's own
window of decode threads.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import models
from bigdl_tpu_torch.cli.common import (add_autotune_arg, add_conv_args,
                                        add_fused_bn_arg,
                                        add_grad_comm_args, add_lint_arg,
                                        add_obs_args, add_pipeline_args,
                                        add_resilience_args, add_strategy_arg)
from bigdl_tpu_torch.obs import memory as _obs_mem
from bigdl_tpu_torch.resilience.faults import hook as _fault_hook

__all__ = ["LM_VOCAB", "LM_CONFIGS", "IMAGE_CONFIGS", "PEAK_FLOPS",
           "peak_flops", "build_model", "record_feed", "train_step",
           "step_flops", "run", "HARD_GRADE", "EASY_GRADE", "resolve_grade",
           "run_time_to_acc", "main"]

# Dense bf16 tensor-core peak of one card (NVIDIA's H100 datasheet: SXM5,
# the part named "NVIDIA H100 80GB HBM3"; NVL; PCIe), matched by substring
# against the squashed (spaces and dashes dropped, lower-cased) device
# name, most specific first. An unmatched name falls back to a nominal
# 1e12 under a label that says so.
PEAK_FLOPS = (
    ("h100nvl", 835e12), ("h100pcie", 756e12),
    ("h10080gbhbm3", 989.4e12), ("h100sxm", 989.4e12),
    ("cpu", 1e12),  # nominal, so MFU stays defined in CPU runs
)


def peak_flops(name: str) -> tuple:
    """(peak FLOP/s, matched label) of the device called ``name`` (a
    ``torch.cuda.get_device_name()``, or "cpu")."""
    kind = name or "cpu"
    squashed = kind.replace(" ", "").replace("-", "").lower()
    for k, v in PEAK_FLOPS:
        if k in squashed:
            return v, k
    return 1e12, f"UNMATCHED({kind})->1e12-nominal"

LM_VOCAB = 32000

LM_CONFIGS = {
    "transformer_lm": dict(d_model=512, num_layers=8, num_heads=8,
                           max_len=512, pos_encoding="sinusoidal",
                           num_kv_heads=None),
    "transformer_lm_rope": dict(d_model=512, num_layers=8, num_heads=8,
                                max_len=512, pos_encoding="rope",
                                num_kv_heads=2),
    "transformer_lm_1k": dict(d_model=1024, num_layers=12, num_heads=16,
                              max_len=1024, pos_encoding="rope",
                              num_kv_heads=4),
    "transformer_lm_1k_hd128": dict(d_model=1024, num_layers=12,
                                    num_heads=8, max_len=1024,
                                    pos_encoding="rope", num_kv_heads=2),
    # long context: the flash kernels at 16k and 32k tokens, remat keeping
    # the activations of 12 layers inside the card
    "transformer_lm_16k": dict(d_model=1024, num_layers=12, num_heads=8,
                               max_len=16384, pos_encoding="rope",
                               num_kv_heads=2, remat="dots"),
    "transformer_lm_32k": dict(d_model=1024, num_layers=12, num_heads=8,
                               max_len=32768, pos_encoding="rope",
                               num_kv_heads=2, remat="full"),
}

# name -> (builder kwargs, input (H, W, C), classes); "arch" names a
# builder of models other than the ResNets. _fbn: the stats kernels; _fba:
# the fused BN block with the conv->BN->ReLU ReLUs absorbed
IMAGE_CONFIGS = {
    "resnet50": (dict(depth=50), (224, 224, 3), 1000),
    "resnet50_s2d": (dict(depth=50, s2d_stem=True), (224, 224, 3), 1000),
    # BN statistics from 32 of the batch's rows
    "resnet50_bnss": (dict(depth=50, bn_stat_sample=32), (224, 224, 3),
                      1000),
    "resnet50_fbn": (dict(depth=50, fused_bn="stats"), (224, 224, 3), 1000),
    "resnet50_fba": (dict(depth=50, fused_bn="apply"), (224, 224, 3), 1000),
    "resnet20_cifar": (dict(depth=20, cifar=True), (32, 32, 3), 10),
    "lenet5": (dict(arch="lenet5"), (28, 28, 1), 10),
    "vgg16": (dict(arch="vgg16"), (224, 224, 3), 1000),
    "vgg19": (dict(arch="vgg19"), (224, 224, 3), 1000),
    "inception_v1": (dict(arch="inception_v1_no_aux"), (224, 224, 3), 1000),
    "inception_v2": (dict(arch="inception_v2"), (224, 224, 3), 1000),
    # 227 x 227, the Caffe geometry its Reshape([256*6*6]) fixes (the JAX
    # harness feeds it 224 x 224, which cannot reshape)
    "alexnet": (dict(arch="alexnet"), (227, 227, 3), 1000),
    # 196 patch tokens of 16 x 16, heads of 128, the flash kernels
    "vit_b16": (dict(arch="vit_b16", attn_impl="flash"), (224, 224, 3),
                1000),
    "vit_s16": (dict(arch="vit_s16", attn_impl="flash"), (224, 224, 3),
                1000),
}


def encoder_of(model):
    """The model's ``TransformerEncoder`` (an LM's or a ViT's), else None:
    the part that takes ``remat`` and runs the flash kernels."""
    from bigdl_tpu_torch.nn import TransformerEncoder

    enc = getattr(model, "encoder", None)
    return enc if isinstance(enc, TransformerEncoder) else None


def build_model(name: str, seq_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                class_num: Optional[int] = None, lm_attn_impl=None, **kw):
    """(model, input shape) for a model of the zoo, on the CPU; weights
    are random from ``generator`` (default seeded 0). An image row has
    ``class_num`` classes (default the row's). For an LM or a ViT row,
    ``kw`` (e.g. ``remat``, ``num_layers``) overrides the row's config;
    an LM's attention is the flash kernels unless ``lm_attn_impl`` names
    another (``--strategy sp``'s ring)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if name in IMAGE_CONFIGS:
        cfg, in_shape, classes = IMAGE_CONFIGS[name]
        cfg = dict(cfg)
        classes = class_num or classes
        stat_sample = cfg.pop("bn_stat_sample", None)
        if "arch" in cfg:
            model = getattr(models, cfg.pop("arch"))(
                classes, generator=generator, **dict(cfg, **kw))
        elif cfg.pop("cifar", False):
            model = models.resnet_cifar(cfg.pop("depth"), classes,
                                        generator=generator, **cfg)
        else:
            model = models.resnet(cfg.pop("depth"), classes,
                                  generator=generator, **cfg)
        if stat_sample:
            from bigdl_tpu_torch.nn import set_bn_stat_sample
            set_bn_stat_sample(model, stat_sample)
        return model, in_shape
    if name not in LM_CONFIGS:
        raise SystemExit(f"model {name} is not in the PyTorch port yet; "
                         f"choose from {sorted(IMAGE_CONFIGS)} or "
                         f"{sorted(LM_CONFIGS)}")
    cfg = dict(LM_CONFIGS[name], **kw)
    if seq_len is not None:
        cfg["max_len"] = int(seq_len)
    model = models.transformer_lm(LM_VOCAB,
                                  attn_impl=lm_attn_impl or "flash",
                                  generator=generator, **cfg)
    return model, (cfg["max_len"],)


RECORD_MEAN = (123.68, 116.779, 103.939)
RECORD_STD = (58.4, 57.1, 57.4)


def _short_side(crop) -> int:
    """The resize target feeding a random crop: 256 for 224, else the same
    8/7 headroom (at least 8)."""
    if tuple(crop) == (224, 224):
        return 256
    return max(8, (max(crop) * 8) // 7)


def record_feed(source: str, batch: int, crop=(224, 224), workers: int = 0,
                depth: int = 2, stage: str = "off", device=None):
    """(endless batch iterator, provenance or None) over the record shards
    of ``source``: random crops of ``crop``, flips, the ImageNet mean and
    std. With ``workers`` > 0 or a ``stage`` the executor (and staging
    thread) feed it, else the record set's own decode window."""
    import os

    from bigdl_tpu_torch.dataset.pipeline import (EpochPlan, ExecutorDataSet,
                                                  StagedDataSet,
                                                  StreamingSampleSource)
    from bigdl_tpu_torch.dataset.streaming import RecordImageDataSet

    executor = workers > 0 or stage != "off"
    rds = RecordImageDataSet(
        source, batch_size=batch, crop=crop, train=True,
        short_side=_short_side(crop), mean=list(RECORD_MEAN),
        std=list(RECORD_STD),
        n_threads=1 if executor else min(32, (os.cpu_count() or 4) * 2),
        window=1 if executor else 4)
    ds, prov = rds, None
    if executor:
        src = StreamingSampleSource(rds)
        plan = EpochPlan(len(src), batch, seed=rds.seed, shuffle=True,
                         process_index=0, process_count=1)
        ds = ExecutorDataSet(src, workers=max(1, workers), depth=depth,
                             plan=plan)
        if stage != "off":
            ds = StagedDataSet(ds, stage=stage, depth=depth, device=device)
        prov = {"workers": max(1, workers), "depth": depth, "stage": stage,
                "signature": ds.signature()}

    def endless():
        while True:
            yield from ds
            ds.shuffle()  # the next epoch's plan

    return endless(), prov


def train_step(model_name: str, batch: int, dtype=torch.bfloat16,
               device=None, remat=False, seq_len: Optional[int] = None,
               fused_bn: Optional[str] = None, data_type: str = "constant",
               graph_steps: int = 0, feed=None, strategy=None,
               attn_impl=None, optim_method=None):
    """(step, model, tokens per step or None, device): ``step()`` takes
    SGD(0.01, momentum 0.9) steps of the zoo model on one resident batch
    from ``np.random.RandomState(0)`` and returns the last loss (not
    synced); a model with dropout draws its masks from the step's seed
    (0 for an eager step). ``fused_bn`` (--fusedBN) is installed on top of
    the row's own BN mode. With ``graph_steps`` = 0 a call is one eager
    step; with K >= 1 a call is K steps, on CUDA one replay of a CUDA
    graph of the K steps (the first call runs them eagerly on the capture
    stream, then captures; :class:`~bigdl_tpu_torch.optim.step_graph.
    StepGraph`), on the CPU K eager steps. With a ``feed`` (an iterator of image batches)
    a call is one eager step on the feed's next batch. Under a
    ``strategy`` (a ``DataParallel`` or ``TensorParallel``; eager steps
    only) ``batch`` is the global batch: each rank steps on its part of
    the data axis, batch norm takes the global batch's statistics, the
    gradients and the loss are averaged over the data axis and the SGD
    state is ZeRO-1's; the loss is the global one. ``attn_impl`` replaces
    an LM's flash attention (``--strategy sp``: the ring, under a
    ``SequenceParallel`` that gives each rank its block of the tokens;
    the encoder then runs without layer remat, since a recomputed layer
    would repeat the ring's hops). ``optim_method`` replaces the SGD."""
    from bigdl_tpu_torch.cli.common import apply_fused_bn
    from bigdl_tpu_torch.core.module import resolve_device, takes_seed
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD

    device = resolve_device(device)
    is_lm = model_name in LM_CONFIGS
    model, in_shape = build_model(model_name, seq_len=seq_len,
                                  lm_attn_impl=attn_impl)
    enc = encoder_of(model)
    if attn_impl is not None and enc is not None:
        enc.remat = False
    elif remat and enc is not None:  # else the row's own
        enc.remat = remat
    apply_fused_bn(model, fused_bn)
    rng = np.random.RandomState(0)
    if is_lm:
        if dtype == torch.bfloat16:
            model.compute_dtype = dtype  # the cast lives after the embedding
        crit = TimeDistributedCriterion(ClassNLLCriterion())
        x = torch.from_numpy(rng.randint(0, LM_VOCAB, (batch, *in_shape))
                             .astype(np.int32))
        y = torch.from_numpy(rng.randint(0, LM_VOCAB, (batch, *in_shape))
                             .astype(np.int32))
        tokens = batch * in_shape[0]
    else:
        crit = ClassNLLCriterion()
        x = (np.ones((batch, *in_shape), np.float32) if data_type ==
             "constant" else rng.randn(batch, *in_shape).astype(np.float32))
        x = torch.from_numpy(x).to(dtype)
        y = torch.from_numpy(rng.randint(0, IMAGE_CONFIGS[model_name][2],
                                         batch).astype(np.int32))
        tokens = None
    model = model.to(device).train()
    opt = optim_method or SGD(learning_rate=0.01, momentum=0.9)
    params = dict(model.named_parameters())
    state = opt.init(params)
    if strategy is not None:
        from bigdl_tpu_torch.interop.checkpoint import model_tensors
        params, _, state = strategy.bind(model).place(
            params, model_tensors(model)[1], state)
        strategy.sync_batch_norm(model)
        x, y = strategy.shard_batch(x, y)
    names, plist = list(params), list(params.values())

    seeded = takes_seed(model)

    def one_step(xd, yd, seed=0):
        out = model(xd, seed=seed) if seeded else model(xd)
        loss = crit(out.float(), yd)
        grads = dict(zip(names, torch.autograd.grad(loss, plist)))
        if strategy is None:
            opt.update(grads, state, params)
        else:
            grads, loss = strategy.reduce_grads(grads, loss)
            strategy.update(opt, grads, state, params)
        return loss.detach()

    if strategy is not None:
        one_step = strategy.compile_step(one_step)
    if feed is not None:
        from bigdl_tpu_torch.optim.optimizer import _batch_to_device

        def put(b):
            xf, yf = _batch_to_device(b, device)
            if strategy is not None:  # the rank's part of a global batch
                xf, yf = strategy.shard_batch(xf, yf)
            return xf.to(dtype), yf

        def fed_step():
            return one_step(*put(next(feed)))

        # the three parts of a fed step, for a loop that meters each
        fed_step.fetch, fed_step.put, fed_step.compute = (
            lambda: next(feed), put, one_step)
        fed_step.opt_state, fed_step.batch = state, None
        return fed_step, model, tokens, device
    xd, yd = x.to(device), y.to(device)
    if graph_steps == 0:
        def eager():
            return one_step(xd, yd)
        step_fn = eager
    elif device.type == "cpu":
        def steps():
            for _ in range(graph_steps):
                loss = one_step(xd, yd)
            return loss
        step_fn = steps
    else:
        step_fn = _graphed(one_step, x, y, xd, yd, graph_steps, device)
    # what the memory plan reads: the optimizer state and the resident
    # batch on the device
    step_fn.opt_state, step_fn.batch = state, (xd, yd)
    return step_fn, model, tokens, device


def _graphed(one_step, x, y, xd, yd, graph_steps: int, device):
    """``graph_steps`` steps of ``one_step`` a call as one CUDA graph
    replay; the first call runs them eagerly on the capture stream, then
    captures."""
    from bigdl_tpu_torch.optim.step_graph import StepGraph

    graph = None

    def replay():
        nonlocal graph
        if graph is not None:
            return graph.replay()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(graph_steps):
                loss = one_step(xd, yd)
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = StepGraph(one_step, (x, y), graph_steps, device, stream)
        graph.put([(x, y)] * graph_steps, [0] * graph_steps)
        graph.capture()
        return loss

    return replay


def step_flops(model, model_name: str, batch: int, dtype=torch.bfloat16,
               seq_len: Optional[int] = None) -> dict:
    """``{"matmul": f, "conv": f}``: the analytic FLOPs of one training
    step of ``model`` (a row of the zoo, built as :func:`train_step` builds
    it, on any device) at ``batch``, counted on fake CPU tensors."""
    from bigdl_tpu_torch.core.module import takes_seed
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.utils.flops import step_flops_by_kind

    kw = {"seed": 0} if takes_seed(model) else None  # as train_step calls
    if model_name in LM_CONFIGS:
        seq = seq_len or LM_CONFIGS[model_name]["max_len"]
        return step_flops_by_kind(
            model, (batch, seq), torch.int32, (batch, seq),
            TimeDistributedCriterion(ClassNLLCriterion()), forward_kwargs=kw)
    in_shape = IMAGE_CONFIGS[model_name][1]
    return step_flops_by_kind(model, (batch, *in_shape), dtype, (batch,),
                              ClassNLLCriterion(), forward_kwargs=kw)


def _annotate_conv_layouts(out: dict) -> None:
    """Stamp the non-default conv layout policy (global triple and
    per-geometry decisions) into a result line, through the shared
    provenance assembly (``cli.provenance``)."""
    from bigdl_tpu_torch.cli.provenance import provenance_dict

    core = provenance_dict()
    for k in ("conv_layouts", "conv_geom"):
        if k in core:
            out[k] = core[k]


def _annotate_autotune(out: dict) -> None:
    """Stamp the run's tuning provenance (the mode, and each consulted
    key's decision or "default") into a result line; nothing under
    ``--autotune off``."""
    from bigdl_tpu_torch.cli.provenance import provenance_dict

    core = provenance_dict()
    if "autotune" in core:
        out["autotune"] = core["autotune"]


def _annotate_bn_fused(out: dict, model) -> None:
    """Stamp the model's BN fusion mode (off/stats/apply) into a result
    line."""
    from bigdl_tpu_torch.cli.provenance import provenance_dict

    out["bn_fused"] = provenance_dict(model)["bn_fused"]


def _annotate_supervisor(out: dict, supervisor) -> None:
    """The fault and recovery log in a result line: under ``--supervise``
    (or ``--elastic``) the supervisor's annotation (attempts, retries,
    events with the injected faults), with only a ``--faultPlan`` the
    injected faults' events; a line made under faults says so."""
    if supervisor is not None:
        out["supervisor"] = supervisor.annotation()
        return
    from bigdl_tpu_torch.resilience.faults import injected_events
    ev = injected_events()
    if ev:
        out["faults"] = ev


@contextlib.contextmanager
def _conv_policy(conv_layout: Optional[str], conv_geom: Optional[str],
                 variant: Optional[str] = None):
    """The conv layout flags installed for one run (and, given the run's
    ``variant``, the tuner's triple for it, ``tuning.
    install_conv_layouts``), and the policy as it was restored after
    it."""
    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.cli.common import apply_conv_args
    from bigdl_tpu_torch.ops import conv2d as c2d

    snap = c2d.policy_snapshot()
    try:
        apply_conv_args(SimpleNamespace(convLayout=conv_layout,
                                        convGeom=conv_geom))
        if variant is not None:
            tuning.install_conv_layouts(variant)
        yield
    finally:
        c2d.restore_policy(snap)


# the step-phase columns, null without --obs; under it the seconds of
# each phase of the timed loop, and stall_frac = data_wait / seconds
_PHASE_COLUMNS = ("data_wait_s", "h2d_s", "dispatch_s", "device_s",
                  "ckpt_s", "stall_frac")
# the attribution columns, null until a capture window closed: the
# collective seconds a step, their share, and the compact attribution
_ATTRIB_COLUMNS = ("collective_s", "collective_frac", "attrib")
# the memory columns, null without --obs: the peak device bytes (the live
# allocator's where the card has it, else the plan's total), the headroom
# against the card's capacity, and the compact plan as ``mem``
_MEM_COLUMNS = ("hbm_peak_bytes", "hbm_headroom_frac", "mem")


def _annotate_obs_phases(out: dict, obs_state, phase: Optional[dict] = None,
                         wall_s: Optional[float] = None,
                         capture_s: float = 0.0) -> None:
    """Stamp the observability columns into a result line. They are
    always present (the schema is stable): null in a run without --obs,
    measured with it. Under --obs the trace, capture and listener
    artifacts ride along as ``obs`` (``capture_s``: the seconds the
    capture windows took to open and close, left out of the timed
    region), and a closed capture window fills the attribution
    columns."""
    for c in _ATTRIB_COLUMNS + _MEM_COLUMNS:
        out[c] = None
    if obs_state is None or not obs_state.enabled or phase is None:
        for c in _PHASE_COLUMNS:
            out[c] = None
        return
    for name in ("data_wait", "h2d", "dispatch", "device", "ckpt"):
        out[f"{name}_s"] = round(phase.get(name, 0.0), 4)
    out["stall_frac"] = (round(phase.get("data_wait", 0.0) / wall_s, 4)
                         if wall_s else None)
    plan = obs_state.mem_plan
    sampler = obs_state.mem_sampler
    if plan is not None:
        live_peak = sampler.peak_bytes if sampler is not None else None
        peak = live_peak or plan["total_bytes"]
        cap = plan["hbm_bytes"]
        out["hbm_peak_bytes"] = int(peak)
        out["hbm_headroom_frac"] = (round((cap - peak) / cap, 4)
                                    if cap else None)
        m = _obs_mem.compact(plan)
        m["source"] = "live" if live_peak else "plan"
        live = sampler.annotation() if sampler is not None else None
        if live:
            m["live"] = live
        out["mem"] = m
    info = obs_state.finalize()
    o: dict = {}
    if "trace_json" in info:
        o["trace_json"] = info["trace_json"]
        o["span_events"] = info["span_events"]
    if "metrics_port" in info:
        o["metrics_port"] = info["metrics_port"]
        o["metrics_url"] = info["metrics_url"]
    if "captures" in info:
        o["capture_s"] = round(capture_s, 4)
        o["captures"] = [
            {k: c[k] for k in ("start_step", "stop_step", "trigger",
                               "ok", "dir", "trace", "error", "attrib",
                               "top", "attrib_error") if k in c}
            for c in info["captures"]]
        for c in reversed(info["captures"]):
            a = c.get("attrib")
            if a:  # the newest attributed window
                steps = max(1, int(a.get("steps") or 1))
                out["attrib"] = a
                out["collective_s"] = round(a["collective_s"] / steps, 6)
                out["collective_frac"] = a["collective_frac"]
                break
    if o:
        out["obs"] = o


def _obs_loop(step, iterations: int, obs_state, device, timed: list):
    """The timed loop under --obs: each dispatch metered into the phases
    (``data_wait`` and ``h2d`` for a fed step, ``dispatch``, and
    ``device``, a wait for the card on the loop's stream), each inside
    its span, the capture controller driven before each dispatch and the
    live memory sampled after it. Returns (phase seconds, seconds the
    capture windows took to open and close)."""
    from bigdl_tpu_torch.obs import get_registry
    from bigdl_tpu_torch.obs.metrics import PhaseMeter

    meter = PhaseMeter()
    meter.observe_into(get_registry())
    capture, sampler = obs_state.capture, obs_state.mem_sampler
    fed = hasattr(step, "fetch")
    cap_s = 0.0
    for i in range(iterations):
        if capture is not None:
            t = time.perf_counter()
            capture.on_step(i)
            cap_s += time.perf_counter() - t
        if fed:
            with meter.phase("data_wait"):
                b = step.fetch()
            with meter.phase("h2d"):
                xy = step.put(b)
        _fault_hook("step")
        with meter.phase("dispatch"):
            loss = step.compute(*xy) if fed else step()
        with meter.phase("device"):
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        if sampler is not None:
            sampler.sample(step=i)
        timed.append(loss)
    meter.publish(get_registry())
    return meter.totals, cap_s


def _profiler(profile_dir: Optional[str], device):
    """A ``torch.profiler`` context writing ``profile_dir/trace.json``,
    or a no-op without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    return profile(activities=acts, on_trace_ready=lambda p:
                   p.export_chrome_trace(os.path.join(profile_dir,
                                                      "trace.json")))


def run(model_name: str, batch: int = 32, iterations: int = 10,
        dtype=torch.bfloat16, warmup: int = 2, device=None, remat=False,
        seq_len: Optional[int] = None, fused_bn: Optional[str] = None,
        data_type: str = "constant", inner_steps: int = 1,
        data_source: Optional[str] = None, data_workers: int = 0,
        prefetch_depth: int = 2, stage: str = "off",
        conv_layout: Optional[str] = None, conv_geom: Optional[str] = None,
        profile_dir: Optional[str] = None, strategy: Optional[str] = None,
        grad_compress: Optional[str] = None, grad_buckets=None,
        data_parallel: bool = False, autotune: Optional[str] = None,
        supervisor=None, elastic=None, obs_state=None) -> dict:
    """Time ``iterations`` dispatches of ``inner_steps`` training steps
    each after ``warmup`` ones (with ``inner_steps`` > 1 a dispatch is a
    CUDA graph of the steps; the first warm-up dispatch runs them eagerly
    and captures the graph); returns the JSON line's fields plus
    ``losses`` (each dispatch's last step's, warm-up first). The rates and
    MFU are over ``iterations * inner_steps`` steps. ``data_source``
    (``record:DIR``) feeds each step from record shards, one step a
    dispatch (:func:`record_feed` with the pipeline arguments).
    ``conv_layout``/``conv_geom`` (the ``--convLayout``/``--convGeom``
    values) hold for this run only; ``profile_dir`` receives a
    ``torch.profiler`` trace of the timed loop.

    ``strategy="dp"`` (``--strategy dp``; ``data_parallel`` is the
    deprecated alias) runs the step data-parallel over the ranks of this
    torchrun job, ``batch`` being the global batch: the rates are global,
    MFU's peak is the card's times the ranks, and the line carries
    ``strategy``, ``n_devices``, ``mesh``, ``grad_compress`` and
    ``grad_buckets`` (with ``grad_comm``, the wire accounting, when
    ``grad_compress`` is active), as the JAX harness's does. ``tp[:K]``
    splits the model Megatron-style; ``sp[:K]`` runs an LM row with ring
    attention over a ``seq`` axis (each rank its block of the tokens, the
    positions global); ``pp[:K]`` and ``ep[:K]`` run the JAX harness's
    GPipe block stack and expert-parallel MoE of the row's geometry
    (:func:`_setup_strategy_harness`). The exits are the JAX harness's:
    one process, ``inner_steps`` > 1, a batch the ranks do not divide,
    compression without a strategy or under pp/ep, sp on a model that is
    not an LM or at a length the seq axis does not divide.

    ``autotune`` (``--autotune``) installs the tuning mode; the line's
    ``autotune`` then names the decisions this run consulted.

    The timed loop visits the ``step`` fault site once a step.
    ``supervisor`` (the ``--supervise`` one) puts its annotation in the
    line as ``supervisor``; without it the injected faults, if any, go in
    as ``faults``. ``elastic`` (an ``ElasticSupervisor``, ``--elastic``)
    makes this call one attempt of an elastic run: the strategy is an
    ``ElasticDataParallel`` over the surviving ranks, the attempt's
    topology is recorded after the warm-up, and the line carries
    ``elastic`` (policy, ``--minDevices``, the effective global batch) and
    ``reshape`` (null when nothing was reshaped).

    ``obs_state`` (``cli.common.install_observability``'s, ``--obs``):
    the timed loop runs as :func:`_obs_loop` (a wait for the card after
    each dispatch; the loop without ``--obs`` is untouched), the capture
    windows get the run's FLOPs and peak for their attribution, and the
    memory plan (``obs/memory.build_plan``) and live sampler are
    installed before the first step, the OOM autopsy around the warm-up.
    The plan's measured total is the allocator's peak over the warm-up
    dispatches (reset before the first), less the bytes allocated before
    the model was built. The line's phase, attribution and memory
    columns (null without ``--obs``) and ``obs`` come from
    :func:`_annotate_obs_phases`."""
    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.nn import bn_fused_mode

    if autotune is not None:
        tuning.set_mode(autotune)
    tuning.reset_decisions()
    t_attempt0 = time.perf_counter()  # an elastic retry's restore starts
    if elastic is not None:
        if (strategy or ("dp" if data_parallel else None)) != "dp":
            raise SystemExit(
                "--elastic composes with --strategy dp only (elastic "
                "reshape is a data-parallel contract)")
        # the surviving roster; below --minDevices SupervisorGaveUp
        elastic.probe()
    sname, strat = _perf_strategy(strategy, data_parallel, grad_compress,
                                  grad_buckets, batch, inner_steps, device,
                                  elastic, model_name)
    obs_on = obs_state is not None and obs_state.enabled
    mem_base = 0  # what the process held before this run's model
    if obs_on and resolve_device(device).type == "cuda":
        mem_base = torch.cuda.memory_allocated(device)
    mesh = getattr(strat, "mesh", strat)  # pp and ep: the mesh itself
    n_dev = mesh.size if strat is not None else 1
    # the conv triple of this run configuration, as the JAX harness
    # resolves it: a record feed or a strategy dispatches one step
    eff_inner = 1 if (data_source is not None or strat is not None) \
        else inner_steps
    variant = ("s2d" if model_name.endswith("_s2d")
               else "inner" if eff_inner > 1 else "plain")
    with _conv_policy(conv_layout, conv_geom, variant):
        if inner_steps > 1 and warmup < 1:
            raise ValueError("inner_steps > 1 needs a warm-up dispatch (it "
                             "captures the graph)")
        feed, prov = None, None
        if data_source is not None:
            if not data_source.startswith("record:"):
                raise SystemExit(f"unknown --data source {data_source!r}")
            if model_name not in IMAGE_CONFIGS:
                raise SystemExit("--data record:DIR feeds the image rows only")
            device = resolve_device(device)
            inner_steps = 1  # a fresh batch every step
            feed, prov = record_feed(
                data_source[len("record:"):], batch,
                crop=IMAGE_CONFIGS[model_name][1][:2], workers=data_workers,
                depth=prefetch_depth, stage=stage, device=device)
        if sname in ("pp", "ep"):
            # the pipeline and the expert-parallel MoE compose with the
            # step itself: a harness of their own, as in the JAX package
            h = _setup_strategy_harness(sname, model_name, batch, mesh,
                                        dict(mesh.shape), dtype, seq_len,
                                        device)
            step, model, tokens, device, kinds = (
                h["step"], h["module"], h["tokens"], h["device"],
                h["flops"])
        else:
            attn = None
            if sname == "sp":
                attn = _sp_attention(strat, model_name, seq_len, remat)
            step, model, tokens, device = train_step(
                model_name, batch, dtype, device, remat, seq_len, fused_bn,
                data_type, graph_steps=inner_steps if inner_steps > 1
                else 0, feed=feed, strategy=strat, attn_impl=attn)
            # the ring's ranks count the global step on a plain twin
            kinds = step_flops(model if attn is None else build_model(
                model_name, seq_len)[0], model_name, batch, dtype, seq_len)
        flops = kinds["matmul"] + kinds["conv"]
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        peak, peak_label = peak_flops(name)
        capture = obs_state.capture if obs_state is not None else None
        if capture is not None:
            # each window's attribution joins the run's own numerators
            capture.step_flops = flops * inner_steps
            capture.flops_by_kind = {k: v * inner_steps
                                     for k, v in kinds.items()}
            capture.peak_flops = peak * n_dev
        if obs_on:
            plan_kw = dict(params=dict(model.named_parameters()),
                           opt_state=getattr(step, "opt_state", None),
                           batch=getattr(step, "batch", None),
                           device=device, batch_size=batch,
                           model_name=model_name)
            # abstract until the warm-up measures it: an OOM in the
            # warm-up reports this one
            obs_state.mem_plan = _obs_mem.build_plan(**plan_kw)
            obs_state.mem_sampler = _obs_mem.HbmSampler(device,
                                                        base_bytes=mem_base)
            _obs_mem.install(plan=obs_state.mem_plan,
                             sampler=obs_state.mem_sampler)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
        with _obs_mem.oom_guard("perf_warmup"):  # a report, then raise
            losses = [float(step()) for _ in range(warmup)]  # each synced
        info = (strat.grad_comm_info() if hasattr(strat, "grad_comm_info")
                else None)  # resolved by the warm-up's first reduce
        if capture is not None:
            capture.grad_comm = info
        if obs_on and device.type == "cuda":
            obs_state.mem_plan = _obs_mem.build_plan(
                torch.cuda.max_memory_allocated(device) - mem_base,
                grad_comm=info, **plan_kw)
            _obs_mem.install(plan=obs_state.mem_plan)
        if elastic is not None:
            # the topology is live (mesh formed, step warmed up): the call
            # after a caught DeviceLossFault closes out the reshape
            from bigdl_tpu_torch.cli.common import _bucket_bytes
            elastic.observe_topology(
                n_dev, bucket_bytes=_bucket_bytes(strat, model),
                restore_ms=(time.perf_counter() - t_attempt0) * 1000.0)
        phase, cap_s = None, 0.0
        with _profiler(profile_dir, device):
            t0 = time.perf_counter()
            timed = []
            if obs_on:
                phase, cap_s = _obs_loop(step, iterations, obs_state, device,
                                         timed)
            else:
                for _ in range(iterations):
                    _fault_hook("step")  # one pointer check without a plan
                    timed.append(step())
            losses += [float(v) for v in timed]  # the first read waits for
            dt = time.perf_counter() - t0 - cap_s  # the last
        steps = iterations * inner_steps
        rps = batch * steps / dt
        mfu = flops * steps / dt / (peak * n_dev)
        out = {"model": model_name, "batch": batch, "iterations": iterations,
               "inner_steps": inner_steps,
               "seconds": round(dt, 4), "records_per_second": round(rps, 2),
               "tokens_per_second": (None if tokens is None else
                                     round(rps * tokens / batch, 1)),
               "dtype": str(dtype).replace("torch.", ""),
               "device": name,
               "mfu": round(mfu, 4), "mfu_pct": round(mfu * 100, 2),
               "mfu_basis": "analytic", "peak_flops_assumed": peak,
               "peak_flops_device_match": peak_label,
               "step_gflops_analytic": round(flops / 1e9, 3),
               "step_gflops_by_kind": {k: round(v / 1e9, 3)
                                       for k, v in kinds.items()},
               "step_gflops_hlo": None,
               "remat": getattr(encoder_of(model), "remat", None) or None,
               "fused_bn": bn_fused_mode(model),
               "data_type": None if tokens is not None else data_type,
               "data": data_source, "pipeline": prov,
               "warmup": warmup, "first_loss": losses[0],
               "final_loss": losses[-1], "losses": losses}
        info = (strat.grad_comm_info() if hasattr(strat, "grad_comm_info")
                else None)
        out.update({
            "strategy": sname,
            "n_devices": n_dev,
            "mesh": dict(mesh.shape) if strat is not None else None,
            "records_per_second_per_device": round(rps / n_dev, 2),
            "grad_compress": info["compress"] if info else "off",
            "grad_buckets": info["n_buckets"] if info else None})
        if info:
            out["grad_comm"] = dict(info)
        if elastic is not None:
            out["elastic"] = {
                "policy": elastic.batch_policy,
                "min_devices": elastic.min_devices,
                "effective_batch": len(strat._fit_rows(np.arange(batch)))}
            out["reshape"] = elastic.reshape_annotation()
        _annotate_obs_phases(out, obs_state, phase, dt, cap_s)
        _annotate_conv_layouts(out)
        _annotate_autotune(out)
        _annotate_supervisor(out, supervisor)
        return out


def _perf_strategy(strategy, data_parallel, grad_compress, grad_buckets,
                   batch, inner_steps, device, elastic=None,
                   model_name: Optional[str] = None):
    """``(name, strategy)`` of ``run``'s strategy arguments: the
    DataParallel (``--strategy dp``), TensorParallel (``tp``, its model
    bound by ``train_step``) or SequenceParallel (``sp``), the mesh of
    ``pp`` and ``ep`` (whose harness builds the step), an
    ElasticDataParallel over the surviving ranks under ``elastic``, or
    ``(None, None)``. Exits as the JAX harness does: sp on a model that
    is not an LM, ``--gradCompress`` without a strategy or under pp/ep."""
    from bigdl_tpu_torch.cli import common

    cpu = device is not None and torch.device(device).type == "cpu"
    args = SimpleNamespace(strategy=strategy, dataParallel=data_parallel,
                           platform="cpu" if cpu else None,
                           gradCompress=grad_compress,
                           gradBuckets=grad_buckets, innerSteps=inner_steps,
                           stepsPerDispatch=1,
                           elastic=(elastic.batch_policy
                                    if elastic is not None else None))
    name, _ = common.resolve_strategy(args)
    strat = common.build_strategy(args, batch=batch, harness=True)
    if name == "sp" and model_name is not None \
            and model_name not in LM_CONFIGS:
        raise SystemExit("--strategy sp shards the sequence axis via ring "
                         "attention; it needs a transformer_lm* model")
    cfg = common.make_grad_comm(args)
    if cfg is not None and cfg.active:
        if strat is None:
            raise SystemExit(
                "--gradCompress compresses the cross-device gradient "
                "all-reduce; it needs a multi-device --strategy (dp)")
        if name in ("pp", "ep"):
            raise SystemExit(
                f"--gradCompress rides DataParallel.reduce_grads; "
                f"--strategy {name} builds its own step structure and has "
                f"no replicated-grad all-reduce to compress")
    return (name if strat is not None else None), strat


def _sp_attention(strat, model_name: str, seq_len: Optional[int], remat):
    """The ring attention of ``--strategy sp`` over ``strat``'s mesh;
    exits for a length the seq axis does not divide (the JAX text) and
    for ``--remat`` (a recomputed layer would repeat the ring's hops)."""
    from bigdl_tpu_torch.parallel import make_ring_attention

    seq = int(seq_len or LM_CONFIGS[model_name]["max_len"])
    n_seq = strat.mesh.shape["seq"]
    if seq % n_seq:
        raise SystemExit(f"--strategy sp: sequence length {seq} must be "
                         f"divisible by the seq axis ({n_seq}); "
                         f"shrink/resize with --seq")
    if remat:
        raise SystemExit("--strategy sp runs the encoder without layer "
                         "remat (a recomputed layer would repeat the "
                         "ring's hops); the ring keeps its own "
                         "sub-block checkpoints")
    return make_ring_attention(strat.mesh, "seq", batch_axis="data")


# (d_model, layers, heads, seq) of the LM rows: the pp and ep harness size
# their block stack and MoE from the model name (the JAX harness's table)
_LM_GEOM = {
    "transformer_lm": (512, 8, 8, 512),
    "transformer_lm_rope": (512, 8, 8, 512),
    "transformer_lm_1k": (1024, 12, 16, 1024),
    "transformer_lm_1k_hd128": (1024, 12, 8, 1024),
    "transformer_lm_16k": (1024, 12, 8, 16384),
    "transformer_lm_32k": (1024, 12, 8, 32768),
}


def _setup_strategy_harness(strat_name: str, model_name: str, batch: int,
                            mesh, mesh_axes: dict, dtype,
                            seq_len: Optional[int] = None, device=None,
                            init: Optional[dict] = None) -> dict:
    """The pp and ep steps of ``cli.perf`` (the JAX harness's): MSE over a
    block stack of the LM row's geometry (:data:`_LM_GEOM`, the length
    overridable by ``seq_len``), SGD(0.01, momentum 0.9), ``x`` and ``y``
    (batch, seq, d) from ``np.random.RandomState(0)``. pp: a
    ``PipelineStack`` of the row's ``TransformerEncoderLayer`` blocks over
    the pipe axis, microbatches = stages, the gradients averaged over the
    data axis. ep: an ``MoE`` of the axis's experts (Linear d -> 2d, ReLU,
    Linear 2d -> d), top-2, capacity 2.0, plus 0.01 times its auxiliary
    loss. The weights are random from a seed, or ``init`` ({name: tensor}
    in the module's names, a JAX tree's ``interop.params_from_jax``).
    ``mesh`` None runs the same step unsplit in one process (the
    reference a parity check holds the harness to). Returns {"step": () ->
    loss, "module", "tokens" a step, "device", "flops": the step's
    analytic FLOPs by kind}."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential, resolve_device
    from bigdl_tpu_torch.nn.moe import collect_aux_losses
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.flops import step_flops_by_kind

    geom = _LM_GEOM.get(model_name)
    if geom is None:
        raise SystemExit(
            f"--strategy {strat_name} sizes its transformer stack from "
            f"the model name; choose one of {sorted(_LM_GEOM)}")
    d_model, layers, heads, seq = geom
    if seq_len is not None:
        seq = int(seq_len)
    device = resolve_device(device)
    mse = nn.MSECriterion()

    def crit(out, y):
        return mse(out.float(), y.float())

    opt = SGD(learning_rate=0.01, momentum=0.9)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(batch, seq, d_model).astype(
        np.float32)).to(dtype)
    y = torch.from_numpy(rs.randn(batch, seq, d_model).astype(
        np.float32)).to(dtype)
    g = torch.Generator().manual_seed(0)

    if strat_name == "pp":
        from bigdl_tpu_torch.parallel import (PipelineStack,
                                              make_pipeline_train_step,
                                              place_pipeline_params)
        stages = mesh_axes["pipe"]
        if layers % stages:
            raise SystemExit(
                f"--strategy pp: {layers} layers must divide over "
                f"{stages} pipeline stages (try pp:{layers // 2} or a "
                "deeper model)")
        micro = stages  # GPipe bubble (P-1)/(M+P-1); M=P keeps it <50%
        data_ax = mesh_axes.get("data", 1)
        if batch % micro or (batch // micro) % data_ax:
            raise SystemExit(
                f"--strategy pp: batch {batch} must split into {micro} "
                f"microbatches of a multiple of the data axis "
                f"({data_ax})")
        module = PipelineStack(lambda: nn.TransformerEncoderLayer(
            d_model, heads, 4 * d_model, generator=g), layers)
    else:
        module = nn.MoE(lambda: Sequential(
            nn.Linear(d_model, 2 * d_model, generator=g), nn.ReLU(),
            nn.Linear(2 * d_model, d_model, generator=g)),
            num_experts=mesh_axes["expert"], d_model=d_model, top_k=2,
            capacity_factor=2.0, generator=g)
    if init is not None:
        module.load_state_dict(init, strict=True)
    # the whole step's FLOPs, counted before the placement cuts it
    flops = step_flops_by_kind(module, x.shape, dtype, y.shape, crit,
                               y_dtype=dtype)
    if mesh is None:
        pass
    elif strat_name == "pp":
        place_pipeline_params(module, mesh, "pipe")
    else:
        module.place_expert_parallel(mesh, "expert")
    module = module.to(device).train()
    params = dict(module.named_parameters())
    names, plist = list(params), list(params.values())
    state = opt.init(params)
    xd, yd = x.to(device), y.to(device)
    if strat_name == "pp" and mesh is not None:
        raw = make_pipeline_train_step(module, mesh, crit, opt, micro,
                                       axis="pipe", data_axis="data")

        def step():
            return raw(state, xd, yd)
    else:
        def step():
            with collect_aux_losses() as aux:
                out = module(xd)
            loss = crit(out, yd) + 0.01 * sum(aux)  # no aux from a stack
            grads = torch.autograd.grad(loss, plist)
            opt.update(dict(zip(names, grads)), state, params)
            return loss.detach()

    return {"step": step, "module": module, "tokens": batch * seq,
            "device": device, "flops": flops}


# synthetic-grade defaults of the time-to-accuracy data: (band or chroma
# contrast, pixel-noise sigma), the JAX harness's
HARD_GRADE = (8.0, 35.0)
EASY_GRADE = (55.0, 30.0)


def resolve_grade(hard: bool, lift: Optional[float],
                  noise: Optional[float]) -> tuple:
    """Effective (lift, noise) after the grade's defaults."""
    g_lift, g_noise = HARD_GRADE if hard else EASY_GRADE
    return (g_lift if lift is None else lift,
            g_noise if noise is None else noise)


def _make_class_image_tree(root: str, classes: int, per_class: int,
                           size: int, seed: int = 0, hard: bool = False,
                           lift: Optional[float] = None,
                           noise: Optional[float] = None) -> None:
    """A learnable synthetic image tree ``root/class<c>/<i>.jpg``, the JAX
    harness's draws and JPEG calls (the same files where PIL is the
    same). Easy grade: a class colour and a bright band at a
    class-specific height under pixel noise. Hard grade
    (``hard=True``): every class the same grey, tinted towards hue angle
    2*pi*c/classes by ``lift`` along a chroma basis orthogonal to Rec.601
    luma, under noise ``noise`` (the one cue that survives random crops,
    resizes, flips and JPEG chroma subsampling)."""
    from PIL import Image

    lift, noise = resolve_grade(hard, lift, noise)
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    v1 = np.array([0.587, -0.299, 0.0], np.float32)
    v1 /= np.linalg.norm(v1)
    v2 = np.cross(luma, v1)
    v2 /= np.linalg.norm(v2)

    rs = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"class{c:03d}")
        os.makedirs(d, exist_ok=True)
        if hard:
            ang = 2.0 * np.pi * c / classes
            chroma = 1.22 * (np.cos(ang) * v1 + np.sin(ang) * v2)
            hue = np.full(3, 110.0, np.float32)
        else:
            chroma = None
            hue = np.array([(40 + c * 53) % 200, (60 + c * 97) % 200,
                            (80 + c * 151) % 200], np.float32)
        band = (c * size) // classes
        bh = max(2, size // classes)
        for i in range(per_class):
            img = np.broadcast_to(hue, (size, size, 3)).copy()
            if hard:
                img += chroma * lift
            else:
                img[band:band + bh] += lift
            img += rs.randn(size, size, 3) * noise
            Image.fromarray(
                np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{i:04d}.jpg"), quality=85)


def run_time_to_acc(model_name: str, batch: int, target: float,
                    max_epochs: int = 40, image_size: int = 64,
                    classes: int = 10, train_per_class: int = 200,
                    val_per_class: int = 40, learning_rate: float = 0.1,
                    use_bf16: bool = True, data_dir: Optional[str] = None,
                    hard: bool = False,
                    val_every_iters: Optional[int] = None,
                    lift: Optional[float] = None,
                    noise: Optional[float] = None,
                    weight_decay: float = 1e-4,
                    fused_bn: Optional[str] = None, device=None,
                    inner_steps: int = 1, conv_layout: Optional[str] = None,
                    conv_geom: Optional[str] = None,
                    supervisor=None, strategy: Optional[str] = None,
                    grad_compress: Optional[str] = None,
                    grad_buckets=None, obs_state=None) -> dict:
    """Time to accuracy (the BASELINE metric's second half; the JAX
    harness's ``run_time_to_acc``): trains ``model_name`` from record
    shards (decode and augment in the timed path), validates top-1 every
    epoch (or every ``val_every_iters`` iterations) against the wall
    clock, stops at ``target`` (``Trigger.max_score``) or ``max_epochs``,
    and reports the first crossing from the validation curve. Without
    ``data_dir`` the data is :func:`_make_class_image_tree`'s; with it,
    its ``train/`` and ``val/`` record shards. ``inner_steps`` > 1 trains
    graphed (``Optimizer(steps_per_dispatch=...)``). Prints and returns
    the JAX line's keys. ``strategy="dp"`` (``--strategy dp``, a torchrun
    job) trains data-parallel over the job's ranks with ``grad_compress``
    and ``grad_buckets`` (``--gradCompress``/``--gradBuckets``), which the
    line's ``grad_compress``/``grad_buckets`` report as the JAX harness's
    do ("off" and null on one device); rank 0 prints the line. Under
    ``obs_state`` (``--obs``) the Optimizer drives its capture controller
    and the line's phase columns are the Optimizer's phase seconds."""
    import shutil
    import tempfile

    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.cli.common import apply_fused_bn
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.dataset import (RecordImageDataSet,
                                         write_image_shards)
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger

    device = resolve_device(device)
    tuning.reset_decisions()  # annotate only this run's consulted keys
    if strategy not in (None, "dp"):
        raise SystemExit(f"--timeToAcc trains data-parallel (--strategy dp),"
                         f" as the JAX harness does; got --strategy "
                         f"{strategy}")
    strat = (_perf_strategy(strategy, False, grad_compress, grad_buckets,
                            batch, inner_steps, device)[1] if strategy
             else None)
    t_setup = time.time()
    td = None
    summary_dir = tempfile.mkdtemp(prefix="tta_summary_")
    try:
        if data_dir is None:
            td = tempfile.mkdtemp(prefix="tta_")
            for split, per in (("train", train_per_class),
                               ("val", val_per_class)):
                tree = os.path.join(td, "imgs", split)
                _make_class_image_tree(tree, classes, per, image_size,
                                       seed=0 if split == "train" else 1,
                                       hard=hard, lift=lift, noise=noise)
                write_image_shards(tree, os.path.join(td, "shards", split),
                                   prefix=split, images_per_shard=256,
                                   workers=4)
            data_dir = os.path.join(td, "shards")

        mean, std = [127.0] * 3, [60.0] * 3
        crop = (image_size, image_size)
        train_ds = RecordImageDataSet(os.path.join(data_dir, "train"),
                                      batch, crop=crop, train=True,
                                      mean=mean, std=std)
        val_ds = RecordImageDataSet(os.path.join(data_dir, "val"), batch,
                                    crop=crop, train=False, mean=mean,
                                    std=std)
        with _conv_policy(conv_layout, conv_geom):
            model, _ = build_model(model_name, class_num=classes)
            apply_fused_bn(model, fused_bn)
            opt = Optimizer(
                model, train_ds, ClassNLLCriterion(),
                optim_method=SGD(learning_rate=learning_rate, momentum=0.9,
                                 weight_decay=weight_decay),
                end_when=Trigger.or_(Trigger.max_epoch(max_epochs),
                                     Trigger.max_score(target)),
                compute_dtype=torch.bfloat16 if use_bf16 else None,
                steps_per_dispatch=inner_steps, device=device,
                strategy=strat)
            val_trig = (Trigger.several_iteration(val_every_iters)
                        if val_every_iters else Trigger.every_epoch())
            opt.set_validation(val_trig, val_ds, [Top1Accuracy()])
            opt.set_summary(summary_dir)
            if obs_state is not None and obs_state.capture is not None:
                opt.set_capture(obs_state.capture)

            t_train = time.time()
            opt.optimize()
            wall = time.time() - t_train
            conv = {}
            _annotate_conv_layouts(conv)
            _annotate_autotune(conv)

        with open(os.path.join(summary_dir, "val.jsonl")) as f:
            curve = [json.loads(line) for line in f]
    finally:
        if td is not None:
            shutil.rmtree(td, ignore_errors=True)
        shutil.rmtree(summary_dir, ignore_errors=True)
    reached = [r for r in curve if r.get("top1_accuracy", 0.0) >= target]
    g_lift, g_noise = resolve_grade(hard, lift, noise)
    info = strat.grad_comm_info() if strat is not None else None
    out = {
        "model": model_name,
        "metric": "time_to_acc",
        "target_top1": target,
        "reached": bool(reached),
        "time_to_acc_s": (round(reached[0]["wall_s"], 2) if reached
                          else None),
        "train_wall_s": round(wall, 2),
        "setup_s": round(t_train - t_setup, 2),
        "final_top1": curve[-1]["top1_accuracy"] if curve else None,
        # distinct epoch stamps across validations: the epoch count, or
        # the epochs touched under --valEvery
        "epochs_run": len({r.get("epoch") for r in curve}),
        "val_points": len(curve),
        "grad_compress": info["compress"] if info else "off",
        "grad_buckets": info["n_buckets"] if info else None,
        "hard_data": hard,
        "grade_lift": g_lift,
        "grade_noise": g_noise,
        "weight_decay": weight_decay,
        "batch": batch,
        "image_size": image_size,
        "classes": classes,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "curve": [{"wall_s": r.get("wall_s"),
                   "top1": r.get("top1_accuracy")} for r in curve],
    }
    _annotate_obs_phases(out, obs_state, opt.phase_totals(), wall)
    out.update(conv)
    _annotate_bn_fused(out, model)
    _annotate_supervisor(out, supervisor)
    if strat is None or strat.writer:
        print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.perf")
    p.add_argument("-m", "--model", default="inception_v1",
                   choices=sorted(IMAGE_CONFIGS) + sorted(LM_CONFIGS))
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-i", "--iteration", type=int, default=10)
    p.add_argument("--innerSteps", type=int, default=1, metavar="K",
                   help="K SGD steps per iteration on the resident batch, "
                        "as one CUDA graph replayed each iteration (K > 1); "
                        "the rate is over iterations x K steps. With "
                        "--timeToAcc: K steps a dispatch, graphed")
    p.add_argument("--dataType", choices=["constant", "random"],
                   default="constant",
                   help="image rows: images of ones or N(0, 1) draws")
    p.add_argument("--f32", action="store_true",
                   help="f32 activations (default bf16: the input images, "
                        "or the LM's activations after the embedding)")
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"])
    p.add_argument("--seq", type=int, default=None,
                   help="override the LM context length (small CPU runs)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="default cuda; cpu runs the kernels' plain versions")
    p.add_argument("--data", default=None, metavar="record:DIR",
                   help="feed each step from the record shards of DIR "
                        "(decode, augment and the copy to the card inside "
                        "the timed loop) instead of a resident batch; with "
                        "--timeToAcc, DIR holds train/ and val/ shards")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed loop "
                        "to DIR/trace.json")
    p.add_argument("--timeToAcc", type=float, default=None, metavar="T",
                   help="run the time-to-accuracy harness instead of the "
                        "throughput loop: train from record shards to val "
                        "top1 >= T (BASELINE metric 'time-to-76%%-top1'; "
                        "synthetic learnable data unless --data record:DIR "
                        "points at real shards)")
    p.add_argument("--maxEpoch", type=int, default=40,
                   help="epoch cap for --timeToAcc")
    p.add_argument("--imageSize", type=int, default=64,
                   help="image side for --timeToAcc synthetic data")
    p.add_argument("--classes", type=int, default=10,
                   help="class count for --timeToAcc (1000 with real "
                        "ImageNet shards via --data record:DIR)")
    p.add_argument("--trainPerClass", type=int, default=200,
                   help="synthetic train images per class for --timeToAcc "
                        "(5000 = CIFAR-10 scale)")
    p.add_argument("--valPerClass", type=int, default=40,
                   help="synthetic val images per class for --timeToAcc "
                        "(1000 = CIFAR-10 scale)")
    p.add_argument("--ttaHard", action="store_true",
                   help="harder synthetic classes (a subtle chroma "
                        "direction, no band or colour cue) so the accuracy "
                        "curve spans several epochs")
    p.add_argument("--valEvery", type=int, default=None, metavar="ITERS",
                   help="validate every N iterations instead of every "
                        "epoch (a denser accuracy-vs-wall-clock curve)")
    p.add_argument("--ttaLift", type=float, default=None,
                   help="override the synthetic grade's contrast: chroma "
                        "amplitude for --ttaHard (default 8), band "
                        "contrast for easy (default 55)")
    p.add_argument("--ttaNoise", type=float, default=None,
                   help="override the synthetic grade's pixel-noise sigma "
                        "(hard default 35, easy 30)")
    p.add_argument("--ttaWd", type=float, default=1e-4,
                   help="weight decay for --timeToAcc (the reference CIFAR "
                        "recipe's 1e-4)")
    add_conv_args(p)
    add_fused_bn_arg(p)
    add_pipeline_args(p)
    p.add_argument("--dataParallel", action="store_true",
                   help="deprecated alias of --strategy dp")
    add_strategy_arg(p)
    add_grad_comm_args(p)
    add_autotune_arg(p)
    add_resilience_args(p)
    add_obs_args(p)
    add_lint_arg(p)
    args = p.parse_args(argv)
    from bigdl_tpu_torch.cli.common import (apply_autotune,
                                            install_fault_plan,
                                            install_observability)
    apply_autotune(args)
    install_fault_plan(args)
    install_observability(args)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    if args.lint:
        rc, args.lint_annotation = _preflight_lint(args)
        if rc:
            return rc
    if args.elastic is not None:
        if args.timeToAcc is not None:
            raise SystemExit(
                "--elastic + --timeToAcc: use the training CLIs (their "
                "run_optimize path reshapes through checkpoint resume); "
                "the perf throughput loop is the elastic harness here")
        from bigdl_tpu_torch.cli.common import _join, run_supervised
        from bigdl_tpu_torch.resilience.elastic import ElasticSupervisor
        from bigdl_tpu_torch.resilience.supervisor import RetryPolicy
        if args.strategy == "dp" or args.dataParallel:
            _join(args)  # every rank in the group before the roster
        sup = ElasticSupervisor(
            RetryPolicy(budget=(args.supervise if args.supervise is not None
                                else 5)),
            min_devices=args.minDevices, batch_policy=args.elastic,
            name="perf")
        return run_supervised(
            sup, lambda _n: _run_line(args, dtype, sup, sup), True)
    if args.supervise is not None:
        from bigdl_tpu_torch.resilience.supervisor import (RetryPolicy,
                                                           Supervisor)
        sup = Supervisor(RetryPolicy(budget=args.supervise), name="perf")
        return sup.run(lambda _n: _run_line(args, dtype, sup))
    return _run_line(args, dtype)


def _preflight_lint(args):
    """``--lint[=strict]``: the lint of this run's configuration before it
    starts (``analysis.lint_config``, over the job's rank count, or
    virtual ranks in one process; rank 0 prints). Returns ``(exit code,
    annotation)``: the annotation, with the mesh it vetted under a
    strategy, goes into the JSON line as ``lint``."""
    from bigdl_tpu_torch.analysis import lint_config
    from bigdl_tpu_torch.cli.common import (apply_conv_args,
                                            resolve_lint_config,
                                            run_preflight_lint)
    from bigdl_tpu_torch.ops.conv2d import policy_snapshot, restore_policy

    world = int(os.environ.get("WORLD_SIZE", "1"))
    cfg = resolve_lint_config(args, n_devices=world if world > 1 else None)
    # the classes of the model the run builds: the row's own (--classes
    # is the time-to-accuracy harness's)
    cfg = dataclasses.replace(cfg, classes=(
        args.classes if args.timeToAcc is not None
        else IMAGE_CONFIGS.get(args.model, (None, None, 1000))[2]))
    snap = policy_snapshot()
    try:
        apply_conv_args(args)  # the run installs them again, as it would
        report = lint_config(cfg)
    finally:
        restore_policy(snap)
    rc, ann = run_preflight_lint(
        report, strict=(args.lint == "strict"),
        quiet=int(os.environ.get("RANK", "0")) != 0)
    if ann is not None and cfg.mesh:
        ann["mesh"] = ",".join(f"{a}:{s}" for a, s in cfg.mesh_axes)
    return rc, ann


def _run_line(args, dtype, supervisor=None, elastic=None) -> dict:
    """One run of ``main``'s parsed flags: the time-to-accuracy harness or
    ``run``, its line printed (by rank 0 of a strategy)."""
    if args.timeToAcc is not None:
        data_dir = None
        if args.data and args.data.startswith("record:"):
            data_dir = args.data[len("record:"):]
        return run_time_to_acc(
            args.model, args.batchSize, args.timeToAcc,
            max_epochs=args.maxEpoch, image_size=args.imageSize,
            classes=args.classes, train_per_class=args.trainPerClass,
            val_per_class=args.valPerClass, use_bf16=not args.f32,
            data_dir=data_dir, hard=args.ttaHard,
            val_every_iters=args.valEvery, lift=args.ttaLift,
            noise=args.ttaNoise, weight_decay=args.ttaWd,
            fused_bn=args.fusedBN, device=args.platform,
            inner_steps=args.innerSteps, conv_layout=args.convLayout,
            conv_geom=args.convGeom, supervisor=supervisor,
            strategy=args.strategy or ("dp" if args.dataParallel else None),
            grad_compress=args.gradCompress, grad_buckets=args.gradBuckets,
            obs_state=getattr(args, "_obs", None))
    out = run(args.model, batch=args.batchSize, iterations=args.iteration,
              dtype=dtype, device=args.platform, remat=args.remat,
              seq_len=args.seq, fused_bn=args.fusedBN,
              data_type=args.dataType, inner_steps=args.innerSteps,
              data_source=args.data, data_workers=args.dataWorkers,
              prefetch_depth=args.prefetchDepth, stage=args.stage,
              conv_layout=args.convLayout, conv_geom=args.convGeom,
              profile_dir=args.profile, strategy=args.strategy,
              grad_compress=args.gradCompress, grad_buckets=args.gradBuckets,
              data_parallel=args.dataParallel, supervisor=supervisor,
              elastic=elastic, obs_state=getattr(args, "_obs", None))
    if getattr(args, "lint_annotation", None) is not None:
        out["lint"] = args.lint_annotation
    line = {k: v for k, v in out.items() if k != "losses"}
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    rc = main()  # the line's dict, or --lint=strict's refusal code
    raise SystemExit(rc if isinstance(rc, int) else 0)
