"""The lint: trace-time static analysis for the H100 path's performance
and correctness anti-patterns (counterpart of ``bigdl_tpu/analysis``,
tpulint and shardlint).

BigDL's operability came from catching configuration mistakes at submit
time, before a cluster burned hours. Here: trace a model's whole train
step on fake tensors (``fx_walk.trace_graph``: no allocation, no kernel,
no card, seconds on the CPU), read the FX graph and the kernel sites the
wrappers recorded, and evaluate the rule registry over them and over the
model tree.

Public surface, the JAX package's:

* :func:`lint_fn`: lint any callable traced with the given arguments
  (graph rules only).
* :func:`lint_perf_model`: lint a perf-zoo model end to end: the model
  built on the ``meta`` device, the SGD train step ``cli.perf`` runs
  (bf16 activations, an f32 loss, the update in place), traced, and the
  graph, module, comm and memory rules.
* :func:`lint_config`: everything one resolved run configuration
  (``cli.common.ResolvedConfig``) would run: :func:`lint_perf_model`,
  the sharded train step of a ``--strategy`` mesh (shardlint, over a fake
  process group of the mesh's size), the serving decode step when
  ``--quantize``/``--speculate``/``--kvPageTokens`` ask for one.
* :func:`preflight_optimizer`: lint a built
  :class:`~bigdl_tpu_torch.optim.Optimizer` before it trains (the
  training CLIs' ``--lint``): its own ``_step`` traced on a meta copy of
  its model, without touching the dataset's shuffle stream.
* :func:`lint_serving`: the serve pre-flight's decode-surface lint.

Findings: :class:`~bigdl_tpu_torch.analysis.report.Finding` /
:class:`~bigdl_tpu_torch.analysis.report.Report`; the rule catalog with
severities is :data:`bigdl_tpu_torch.analysis.rules.CATALOG`, and the
stated differences from the JAX rules are in ``rules.py``,
``sharding_rules.py`` and ``fx_walk.py``. The strategies the port traces
over a mesh are dp and tp; sp, pp and ep compose inside the perf
harness and are reported as not traced, as the JAX lint reports pp and
ep.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from bigdl_tpu_torch.analysis.report import Finding, Report, SEVERITIES
from bigdl_tpu_torch.analysis.rules import (CATALOG, check_launch_plan,
                                            run_comm_rules,
                                            run_decode_rules,
                                            run_jaxpr_rules,
                                            run_memory_rules,
                                            run_module_rules,
                                            run_serving_tp_rules)
from bigdl_tpu_torch.analysis.sharding_rules import (
    SHARD_CATALOG, run_kv_sharding_rules, run_replicated_operand_rules,
    run_sharding_rules)

__all__ = ["Finding", "Report", "SEVERITIES", "CATALOG", "SHARD_CATALOG",
           "check_launch_plan", "run_jaxpr_rules", "run_module_rules",
           "run_comm_rules", "run_memory_rules", "run_decode_rules",
           "run_serving_tp_rules", "run_sharding_rules",
           "run_replicated_operand_rules", "run_kv_sharding_rules",
           "lint_fn", "trace_train_step", "trace_sharded_train_step",
           "lint_perf_model", "lint_config", "lint_serving",
           "preflight_optimizer"]


def _trace_error(what: str, e: BaseException, hint: str) -> Finding:
    return Finding(rule="lint-trace-error", family="meta", severity="info",
                   message=f"{what} skipped ({type(e).__name__}: {e})",
                   hint=hint)


def _host_sync(e) -> Finding:
    """The host-sync finding of a trace that stopped on a data-dependent
    branch (``fx_walk.DataDependentTrace``)."""
    fam, sev, _ = CATALOG["host-sync"]
    return Finding(rule="host-sync", family=fam, severity=sev,
                   message=f"the step reads a value off the device and "
                           f"branches on it ({e}) — every iteration waits "
                           "for the card",
                   where=e.where,
                   hint="keep the decision on the card (torch.where) or "
                        "take it outside the step")


def lint_fn(fn, *args, report: Optional[Report] = None,
            state_argnums=None, mode=None, **kwargs) -> Report:
    """Trace ``fn(*args, **kwargs)`` on fake tensors (tensor arguments
    real, meta or fake; ``mode`` the fake mode fake ones were made in)
    and run every graph rule. ``state_argnums``: the
    positional arguments that are the step's train state, for the
    donation rules (the counterpart of a jitted step's round-tripping
    inputs)."""
    from bigdl_tpu_torch.analysis import fx_walk
    from torch.utils._pytree import tree_leaves

    report = report if report is not None else Report()
    try:
        gm = fx_walk.trace_graph(fn, *args, mode=mode, **kwargs)
    except fx_walk.DataDependentTrace as e:
        return report.add(_host_sync(e))
    if state_argnums:
        pos, state = 0, []
        for k, a in enumerate(args):
            n = sum(1 for t in tree_leaves(a) if isinstance(t, torch.Tensor))
            if k in tuple(state_argnums):
                state += list(range(pos, pos + n))
            pos += n
        gm.meta["state_inputs"] = state
    return run_jaxpr_rules(gm, report)


def _is_lm(name: str) -> bool:
    return name.startswith("transformer_lm")


def _build(name: str, classes: int = 1000, seq_len=None):
    """(model, input shape) of a perf-zoo row, on the meta device."""
    from bigdl_tpu_torch.cli.perf import build_model

    with torch.device("meta"):
        if _is_lm(name):
            return build_model(name, seq_len=seq_len)
        return build_model(name, class_num=classes)


def _inputs(in_shape, batch: int, dtype, is_lm: bool):
    """The step's (x, y) on the meta device: token ids for an LM, else
    images in the activation dtype (the perf harness feeds them cast)."""
    if is_lm:
        x = torch.empty((batch, *in_shape), dtype=torch.int32, device="meta")
        return x, torch.empty_like(x)
    return (torch.empty((batch, *in_shape), dtype=dtype, device="meta"),
            torch.empty((batch,), dtype=torch.int32, device="meta"))


def _criterion(is_lm: bool):
    from bigdl_tpu_torch import nn
    return (nn.TimeDistributedCriterion(nn.ClassNLLCriterion()) if is_lm
            else nn.ClassNLLCriterion())


def _one_step(model, crit, opt, strategy=None, donate=True):
    """The perf harness's step (``cli.perf.train_step``'s ``one_step``):
    forward, f32 loss, gradients, the (strategy's) update in place, or,
    with ``donate`` off, fresh parameters returned beside the loss."""
    from bigdl_tpu_torch.core.module import takes_seed

    seeded = takes_seed(model)

    def step(params, state, x, y):
        out = model(x, seed=0) if seeded else model(x)
        loss = crit(out.float(), y)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if strategy is not None:
            grads, loss = strategy.reduce_grads(grads, loss)
            strategy.update(opt, grads, state, params)
        elif donate:
            opt.update(grads, state, params)
        else:
            return loss, {n: p.detach() - 0.01 * grads[n]
                          for n, p in params.items()}
        return loss

    return step


def _state_inputs(*trees) -> list:
    from torch.utils._pytree import tree_leaves
    n = sum(1 for t in trees for x in tree_leaves(t)
            if isinstance(x, torch.Tensor))
    return list(range(n))


def trace_train_step(model, in_shape, batch, *, dtype=None, is_lm=False,
                     vocab: int = 32000, donate=(0, 1, 2)):
    """The FX graph of the canonical SGD train step over ``model`` at
    ``batch`` x ``in_shape``: the step ``cli.perf`` runs (SGD(0.01,
    momentum 0.9) in place, bf16 activations by default, the loss on the
    f32 output), traced on fake tensors of a meta copy of ``model`` (the
    model is not touched). ``donate`` falsy: the update returns fresh
    parameters instead. ``vocab`` is the LM's (read off the model)."""
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.optim import SGD

    dtype = torch.bfloat16 if dtype is None else dtype
    clone = fx_walk.meta_clone(model).train()
    if is_lm and dtype == torch.bfloat16:
        clone.compute_dtype = dtype  # the cast lives after the embedding
    mode = fx_walk.fake_mode()
    opt = SGD(learning_rate=0.01, momentum=0.9)
    with mode:
        fx_walk.fakeify_(clone, mode)
        params = dict(clone.named_parameters())
        state = opt.init(params)
    x, y = _inputs(in_shape, batch, dtype, is_lm)
    with torch.enable_grad():
        gm = fx_walk.trace_graph(
            _one_step(clone, _criterion(is_lm), opt, donate=bool(donate)),
            params, state, x, y, mode=mode)
    gm.meta["state_inputs"] = _state_inputs(params, state)
    return gm


def trace_sharded_train_step(model, in_shape, batch, *, mesh_axes,
                             dtype=None, is_lm=False, grad_comm=None,
                             donate=(0, 1, 2), mesh=None):
    """The FX graph of rank 0's SGD train step under the declared
    ``mesh_axes`` (axis -> size), plus what shardlint reads:
    ``(graph, {"param_specs", "mesh_axes", "params", "mesh"})``.

    The strategy is the one the run would build: a ``TensorParallel``
    (Megatron specs, with their divisibility fallbacks, so a misfitting tp
    degree shows here as it would on the cards) when a ``model`` axis >
    1, else a ``DataParallel``, with ``grad_comm``'s buckets; the batch is
    the global one, of which the strategy gives rank 0 its part. The mesh
    is built over a fake process group of the mesh's size
    (``fx_walk.fake_world``; nothing is sent), or is ``mesh`` (a job's
    own, whose collectives on fake tensors send nothing either). ``params``
    is the whole model's param tree (JAX paths, meta leaves)."""
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.interop.checkpoint import model_tensors
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import DataParallel, make_mesh
    from bigdl_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          megatron_specs,
                                                          param_tree,
                                                          replicated_specs)

    axes = {str(k): int(v) for k, v in dict(mesh_axes).items()}
    dtype = torch.bfloat16 if dtype is None else dtype
    clone = fx_walk.meta_clone(model).train()
    if is_lm and dtype == torch.bfloat16:
        clone.compute_dtype = dtype
    whole = param_tree(clone)
    k = axes.get("model", 1)
    specs = (megatron_specs(clone, whole, "model", k) if k > 1
             else replicated_specs(whole))
    opt = SGD(learning_rate=0.01, momentum=0.9)
    with fx_walk.fake_world(math.prod(axes.values())):
        mesh = mesh if mesh is not None else make_mesh(axes)
        strat = (TensorParallel(mesh, clone, grad_comm=grad_comm) if k > 1
                 else DataParallel(mesh, grad_comm=grad_comm))
        mode = fx_walk.fake_mode()
        x, y = _inputs(in_shape, batch, dtype, is_lm)
        with mode:
            fx_walk.fakeify_(clone, mode)
            params = dict(clone.named_parameters())
            state = opt.init(params)
            params, _, state = strat.bind(clone).place(
                params, model_tensors(clone)[1], state)
            strat.sync_batch_norm(clone)
            x, y = strat.shard_batch(mode.from_tensor(x, static_shapes=True),
                                     mode.from_tensor(y, static_shapes=True))
        step = strat.compile_step(_one_step(clone, _criterion(is_lm), opt,
                                            strategy=strat))
        with torch.enable_grad():
            gm = fx_walk.trace_graph(step, params, state, x, y, mode=mode)
        gm.meta["state_inputs"] = _state_inputs(params, state)
        gm.meta["mesh_groups"] = fx_walk.mesh_groups(mesh)
    return gm, {"param_specs": specs, "mesh_axes": axes, "params": whole,
                "mesh": mesh}


def _bn_fallback_rule(model, graph, report: Report) -> None:
    """Model + graph rule: fused BN was asked for on eligible sites, but
    fewer forward BN kernel sites were traced than sites (``tile-bn-
    fallback``)."""
    from bigdl_tpu_torch.analysis.fx_walk import kernel_sites
    from bigdl_tpu_torch.nn.norm import BatchNormalization

    sites = [m for m in model.modules()
             if isinstance(m, BatchNormalization) and m.fused
             and m.affine and m.axis_name is None and not m.stat_sample]
    if not sites:
        return
    traced = sum(1 for s in kernel_sites(graph)
                 if s.kernel in ("bn_fwd_apply", "bn_stats")
                 and len(s.shapes) == 1)
    # a sync-BN or stats-only forward counts its bn_stats; the backward's
    # bn_bwd_stats takes two operands
    if traced < len(sites):
        report.add(Finding(
            rule="tile-bn-fallback", family="tiling", severity="warning",
            message=(f"fused BN requested on {len(sites)} eligible "
                     f"site(s) but only {traced} fused stats/apply "
                     "kernel site(s) traced — the rest ran the plain "
                     "path"),
            hint="check the site's mode (training, affine, no stat "
                 "sampling) and that the step runs on the card",
            detail={"eligible_sites": len(sites),
                    "traced_kernels": traced}))


def _lint_device():
    """The device whose memory the HBM rules read: the card where there
    is one, else the CPU nominal (``obs.memory``)."""
    return "cuda" if torch.cuda.is_available() else None


def lint_perf_model(name: str, batch: int = 32, *, seq_len=None,
                    dtype=None, fused_bn=None, classes: int = 1000,
                    trace: bool = True, strategy=None,
                    grad_compress=None) -> Report:
    """Full lint of one perf-zoo model (see the module docstring): the
    model built on the meta device as ``cli.perf`` builds it (LMs run the
    flash kernels), ``fused_bn`` installed, the module rules, the comm
    rules under a multi-device ``strategy`` (``--strategy`` spelling),
    the traced step's graph rules (``trace=False`` skips the trace) and
    the memory rules over the step's trees."""
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.cli.common import apply_fused_bn
    from bigdl_tpu_torch.parallel.tensor_parallel import param_tree

    dtype = torch.bfloat16 if dtype is None else dtype
    model, in_shape = _build(name, classes, seq_len)
    apply_fused_bn(model, fused_bn)
    is_lm = _is_lm(name)
    seq = in_shape[0] if is_lm else None

    report = Report()
    dtname = str(dtype).replace("torch.", "")
    run_module_rules(model, report, seq=seq, dtype=dtname)
    if strategy is not None:
        from bigdl_tpu_torch.cli.common import parse_strategy_spec

        strat_name, _ = parse_strategy_spec(strategy)
        run_comm_rules(param_tree(model), strat_name, grad_compress, report)
    if trace:
        try:
            graph = trace_train_step(model, in_shape, batch, dtype=dtype,
                                     is_lm=is_lm)
        except fx_walk.DataDependentTrace as e:
            report.add(_host_sync(e))
        except Exception as e:
            report.add(_trace_error("step trace", e,
                                    "the module-level rules still ran"))
        else:
            run_jaxpr_rules(graph, report)
            _bn_fallback_rule(model, graph, report)
    # HBM working-set rule: the plan over the trees the perf step holds
    # (argument-side categories only), so "plan exceeds HBM" fires before
    # anything is allocated
    try:
        from bigdl_tpu_torch.obs import memory
        from bigdl_tpu_torch.optim import SGD

        params = dict(model.named_parameters())
        opt_state = SGD(learning_rate=0.01, momentum=0.9).init(params)
        plan = memory.build_plan(params=params, opt_state=opt_state,
                                 batch=_inputs(in_shape, batch, dtype,
                                               is_lm),
                                 batch_size=batch, model_name=name,
                                 device=_lint_device())
        run_memory_rules(plan, report)
    except Exception as e:
        report.add(_trace_error("memory rules", e,
                                "the graph/module rules still ran"))
    return report


def _serving_page_tokens(model, cfg_pages, quantize):
    """The page size the serving surface runs: the given one, else for
    kv8 (a page-pool layout) the first of 128/64/32/256 dividing max_len
    (serve's pick)."""
    if cfg_pages or not (quantize and "kv8" in quantize):
        return cfg_pages
    return next((c for c in (128, 64, 32, 256)
                 if model.max_len % c == 0), None)


def lint_serving(model, *, slots: int = 4, kv_page_tokens=None,
                 speculate: int = 0, quantize=None, tp: int = 1, mesh=None,
                 cache_dtype=None, report: Optional[Report] = None
                 ) -> Report:
    """The decode surface of one served LM: its decode step traced on an
    abstract engine (``serving.decode.abstract_decode_engine``: a meta
    copy of ``model``, placed for ``tp`` ranks) and the decode rules;
    under tp > 1 also shardlint over rank 0's decode step (serving
    context), the KV head-split fit of the whole model's cache and the
    replicated-operand rule over the serving layout. ``mesh``: the tp
    engine's mesh in a job that has one (else a fake process group of
    ``tp`` ranks)."""
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.parallel.tensor_parallel import param_tree
    from bigdl_tpu_torch.serving.decode import abstract_decode_engine
    from bigdl_tpu_torch.serving.sharding import ServingSharding, serving_mesh

    report = report if report is not None else Report()
    tp = int(tp)
    kvp = _serving_page_tokens(model, kv_page_tokens, quantize)
    world = (fx_walk.fake_world(tp) if tp > 1 and mesh is None
             else contextlib.nullcontext())
    with world:
        if tp > 1 and mesh is None:
            mesh = serving_mesh()
        whole = fx_walk.meta_clone(model)
        graph = None
        try:
            eng = abstract_decode_engine(
                model, slots=slots, kv_page_tokens=kvp, speculate=speculate,
                quantize=quantize, cache_dtype=cache_dtype, tp=tp,
                mesh=mesh)
            graph = eng.trace_step_graph()
            if tp > 1:
                graph.meta["mesh_groups"] = fx_walk.mesh_groups(mesh)
        except fx_walk.DataDependentTrace as e:
            report.add(_host_sync(e))
        except Exception as e:
            report.add(_trace_error("serving decode trace", e,
                                    "the training-side passes still ran"))
        # the page layout's fit needs no trace
        run_decode_rules(graph, page_tokens=kvp, max_len=whole.max_len,
                         head_dim=whole.encoder[0].mha.head_dim,
                         dtype=cache_dtype or whole.compute_dtype,
                         report=report)
        if graph is not None and tp > 1:
            run_sharding_rules(graph, mesh_axes={"model": tp},
                               strategy=None, context="serving",
                               report=report)
            run_kv_sharding_rules(eng.whole_kv, tp, page_tokens=kvp,
                                  report=report)
            run_replicated_operand_rules(
                param_tree(whole), {"model": tp},
                specs=ServingSharding(mesh).param_specs(whole),
                report=report)
    return report


def lint_config(cfg, mesh=None) -> Report:
    """Lint everything one resolved run configuration would run
    (``cli.common.ResolvedConfig``, the one object the lint CLI and every
    pre-flight hand over): the single-device pass
    (:func:`lint_perf_model`), the sharded train step when ``--strategy``
    declares a dp or tp mesh (shardlint, rank 0's step over a fake
    process group of the mesh's size, or over ``mesh``, a job's own), and
    the serving decode surface when ``--quantize``/``--speculate``/
    ``--kvPageTokens`` ask for one."""
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    strat_spec = None
    if cfg.strategy:
        strat_spec = (f"{cfg.strategy}:{cfg.strategy_k}"
                      if cfg.strategy_k else cfg.strategy)
    report = lint_perf_model(cfg.model, cfg.batch, seq_len=cfg.seq,
                             dtype=dtype, fused_bn=cfg.fused_bn,
                             classes=cfg.classes, trace=cfg.trace,
                             strategy=strat_spec,
                             grad_compress=cfg.grad_compress)
    axes = cfg.mesh
    is_lm = _is_lm(cfg.model)
    grad_comm = cfg.make_grad_comm()

    # ------------------------------------------- sharded training step
    if cfg.trace and axes and cfg.strategy in ("dp", "tp"):
        from bigdl_tpu_torch.cli.common import apply_fused_bn

        model, in_shape = _build(cfg.model, cfg.classes, cfg.seq)
        apply_fused_bn(model, cfg.fused_bn)
        try:
            graph, meta = trace_sharded_train_step(
                model, in_shape, cfg.batch, mesh_axes=axes, dtype=dtype,
                is_lm=is_lm, grad_comm=grad_comm, mesh=mesh)
        except Exception as e:
            report.add(_trace_error("sharded step trace", e,
                                    "the single-device passes still ran"))
        else:
            run_sharding_rules(graph, mesh_axes=meta["mesh_axes"],
                               strategy=cfg.strategy, grad_comm=grad_comm,
                               param_specs=meta["param_specs"],
                               params=meta["params"], context="train",
                               report=report)
    elif cfg.strategy in ("sp", "pp", "ep"):
        report.add(Finding(
            rule="lint-trace-error", family="meta", severity="info",
            message=f"--strategy {cfg.strategy}: the ring/staged/expert "
                    "step composes inside the perf harness; shardlint "
                    "traces dp/tp step graphs",
            hint="the config-level comm rules above still apply"))

    # ------------------------------------------- serving decode surface
    if cfg.trace and (cfg.quantize or cfg.speculate or cfg.kv_page_tokens):
        if not is_lm:
            report.add(Finding(
                rule="lint-trace-error", family="meta", severity="info",
                message="--quantize/--speculate/--kvPageTokens describe "
                        "the LM serving surface; skipped for "
                        f"{cfg.model}",
                hint="lint a transformer_lm* model to cover decode"))
        else:
            smodel, _ = _build(cfg.model, cfg.classes, cfg.seq)
            smodel.compute_dtype = dtype if dtype != torch.float32 else None
            tp_k = int(axes.get("model", 1)) if cfg.strategy == "tp" else 1
            lint_serving(smodel, slots=cfg.slots,
                         kv_page_tokens=cfg.kv_page_tokens,
                         speculate=cfg.speculate, quantize=cfg.quantize,
                         tp=tp_k, report=report)
    return report


def _dataset_geometry(ds):
    """(features, labels, batch size) a dataset exposes without drawing a
    batch (reading them does not advance its shuffle stream), or Nones."""
    return (getattr(ds, "features", None), getattr(ds, "labels", None),
            getattr(ds, "batch_size", None))


def _strategy_name(strategy) -> Optional[str]:
    from bigdl_tpu_torch.parallel import DataParallel
    from bigdl_tpu_torch.parallel.tensor_parallel import TensorParallel

    if isinstance(strategy, TensorParallel):
        return "tp"
    if isinstance(strategy, DataParallel):
        return "dp"
    return None


def preflight_optimizer(opt) -> Report:
    """Lint a built Optimizer before it trains (the training CLIs'
    ``--lint``). Module rules always run; the comm rules under a
    strategy; the step is traced when the dataset exposes its batch
    geometry (``features``/``labels``/``batch_size``: reading them, unlike
    pulling a batch, does not advance the shuffle stream that a
    step-equivalent resume depends on): on one device the Optimizer's own
    ``_step`` over a meta copy of its model, under a dp/tp strategy rank
    0's sharded step over the strategy's mesh (shardlint)."""
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.parallel.tensor_parallel import param_tree

    report = Report()
    dtname = ("bfloat16" if getattr(opt, "compute_dtype", None) is not None
              else "float32")
    run_module_rules(opt.model, report, dtype=dtname)

    strat_name = None
    if opt.strategy is not None:
        strat_name = _strategy_name(opt.strategy)
        cfg = getattr(opt.strategy, "grad_comm", None)
        compress = cfg.compress if cfg is not None else None
        run_comm_rules(param_tree(opt.model), strat_name, compress, report)

    feats, labs, bs = _dataset_geometry(opt.dataset)
    if feats is None or labs is None or not bs:
        return report
    if opt.strategy is not None:
        if strat_name is None:
            return report
        try:
            smeta = opt.strategy.lint_spec_metadata()
            dt = (torch.bfloat16 if getattr(opt, "compute_dtype", None)
                  is not None else torch.float32)
            graph, meta = trace_sharded_train_step(
                opt.model, tuple(feats.shape[1:]), int(bs),
                mesh_axes=smeta["mesh_axes"], dtype=dt, is_lm=False,
                grad_comm=smeta.get("grad_comm"), mesh=opt.strategy.mesh)
            run_sharding_rules(
                graph, mesh_axes=meta["mesh_axes"],
                strategy=smeta.get("strategy", strat_name),
                grad_comm=smeta.get("grad_comm"),
                param_specs=meta["param_specs"], params=meta["params"],
                context="train", report=report)
        except Exception as e:
            report.add(_trace_error("sharded step trace", e,
                                    "module/comm rules still ran"))
        return report
    try:
        import copy

        from bigdl_tpu_torch.core.module import takes_seed

        clone = fx_walk.meta_clone(opt.model).train()
        mode = fx_walk.fake_mode()
        runner = copy.copy(opt)
        runner.model = clone
        with mode:
            fx_walk.fakeify_(clone, mode)
            params = dict(clone.named_parameters())
            state = opt.optim_method.init(params)
        x, y = (torch.empty((int(bs),) + tuple(a.shape[1:]),
                            dtype=torch.as_tensor(a[:0]).dtype,
                            device="meta") for a in (feats, labs))
        seeded = takes_seed(clone)
        with torch.enable_grad():
            graph = fx_walk.trace_graph(
                lambda p, s, xb, yb: runner._step(
                    p, s, xb, yb, 0 if seeded else None, seeded),
                params, state, x, y, mode=mode)
        graph.meta["state_inputs"] = _state_inputs(params, state)
        run_jaxpr_rules(graph, report)
        _bn_fallback_rule(clone, graph, report)
    except fx_walk.DataDependentTrace as e:
        report.add(_host_sync(e))
    except Exception as e:  # surface, never block training on lint bugs
        report.add(_trace_error("step trace", e,
                                "module-level rules still ran"))
    return report
