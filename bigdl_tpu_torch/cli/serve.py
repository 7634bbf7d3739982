"""Serve a model of the perf zoo over HTTP on the GPU (counterpart of
``bigdl_tpu/cli/serve.py``)::

    python -m bigdl_tpu_torch.cli.serve transformer_lm_1k_hd128 --randomInit
    curl -d '{"tokens": [3, 1, 4], "max_new_tokens": 8}' \\
        localhost:8000/generate
    python -m bigdl_tpu_torch.cli.serve resnet50 --model CKPT \\
        --fusedBN apply --autotune cached --buckets 1,2,4,8,16,32

An image classifier (every image row of ``cli.perf.build_model``:
``--classes`` sets its class count) serves ``/predict`` alone: NHWC f32
images in, its log-probabilities out, one CUDA graph a batch bucket.
``--fusedBN``, ``--convLayout``, ``--convGeom`` and ``--autotune`` are the
perf harness's flags, installed before the model is built, so the served
program is the one the harness measured; an eval-mode batch norm runs on
its running statistics, so a served ResNet launches no BN kernel.

``/generate`` runs continuous-batching decode over a dense KV cache, or
a paged one (``--kvPageTokens N|auto``) with the shared-prefix cache
(``--prefixCache``), optionally speculative (``--speculate K``, the draft
the target itself or a seeded ``--draftDims`` model) and quantized
(``--quantize int8|fp8`` weights, ``kv8`` page pools; the greedy agreement
and logit error against the full-precision model are measured at start-up
and stamped into the provenance); ``/predict`` the bucketed full forward,
its rows
padded to the prompt ladder's lengths (16 ... max_len). Every prefill
and every full forward goes through the CUDA flash-attention kernel, and
on the card the decode step, each prefill bucket and each ``/predict``
bucket replay CUDA graphs captured before the server's threads start.
Weights come from ``--randomInit`` (seeded) or ``--model CKPT``, a
``model.<n>`` written by the port or the JAX package. ``--platform cpu``
runs the same stack on the CPU, eagerly, with the kernel's plain version.
``--kvPageTokens auto`` asks the tuner's ``kv_pages`` namespace under
``--autotune cached|measure``, else takes the ladder.

``/generate`` with ``"stream": true`` answers in SSE frames.
``--reqTrace on`` traces every request's lifecycle (``/debug/requests``,
TTFT/TPOT/ITL histograms); ``--slo ttft=MS,tpot=MS`` and ``--accessLog
FILE`` (sampled by ``--logSample``) imply it. ``--faultPlan`` injects
seeded faults at the serving sites. ``--fleet K`` makes this process a
router in front of K worker processes (``serving.fleet``; the router
imports no torch), with ``--modelVersion``, ``--fleetHeartbeatS`` and
``--fleetRestartBudget``. ``--lint[=strict]`` runs the lint pre-flight
(``bigdl_tpu_torch.analysis``) before anything is dispatched: the served
forward of the first replica, and for an LM its decode step (traced on an
abstract engine), under ``tp:K`` the replicated-weight rule and
shardlint over rank 0's decode step with the KV head-split fit; strict
refuses to serve on an error, and the mesh it vetted is stamped into the
provenance as ``lint_mesh``.
"""

from __future__ import annotations

import argparse
import logging

from bigdl_tpu_torch.cli.common import (QUANTIZE_CHOICES, add_autotune_arg,
                                        add_conv_args, add_fused_bn_arg,
                                        add_lint_arg)

__all__ = ["build_parser", "build_app", "main"]

# the page sizes --quantize kv8 tries when --kvPageTokens is not given
_KV8_PAGES = (128, 64, 32, 256)


def _parse_buckets(spec: str):
    try:
        out = tuple(sorted({int(t) for t in spec.split(",") if t.strip()}))
        if not out or out[0] < 1:
            raise ValueError
        return out
    except ValueError:
        raise SystemExit(f"--buckets {spec!r}: expected a comma-separated "
                         f"list of positive ints, e.g. 1,2,4,8,16,32")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "python -m bigdl_tpu_torch.cli.serve",
        description="online inference over HTTP on the GPU: bucketed "
                    "/predict, continuous-batching /generate (LMs), "
                    "/metrics")
    p.add_argument("model", help="a perf-zoo row: transformer_lm, "
                                 "transformer_lm_rope, transformer_lm_1k, "
                                 "transformer_lm_1k_hd128, or an image row "
                                 "(resnet50, resnet20_cifar, lenet5, vgg16, "
                                 "inception_v1, vit_b16, ...)")
    p.add_argument("--model", dest="checkpoint", default=None,
                   metavar="CKPT",
                   help="checkpoint to serve: a directory's newest "
                        "model.<n>, or one file, written by the port or "
                        "the JAX package")
    p.add_argument("--randomInit", action="store_true",
                   help="serve weights drawn from a seeded generator")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=8000,
                   help="0 = ephemeral (the chosen port is printed)")
    p.add_argument("--fleet", type=int, default=0, metavar="K",
                   help="run K engine worker processes behind a router on "
                        "this port: SLO-burn-weighted least-loaded routing, "
                        "supervised restart of dead workers, rolling weight "
                        "swap through POST /admin/reload. 0 (default): one "
                        "process")
    p.add_argument("--modelVersion", default=None, metavar="TAG",
                   help="version tag of the served weights, stamped into "
                        "provenance and echoed as x-model-version; "
                        "/admin/reload sets it (default v0)")
    p.add_argument("--fleetHeartbeatS", type=float, default=0.5,
                   help="router -> worker heartbeat poll interval")
    p.add_argument("--fleetRestartBudget", type=int, default=8,
                   help="supervised restarts of each worker before the "
                        "router leaves it down (exponential backoff "
                        "between them)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device to serve on; cpu runs the kernels' plain "
                        "versions")
    p.add_argument("--buckets", default="1,2,4,8,16,32",
                   help="/predict batch-size buckets; requests pad up to "
                        "the nearest")
    p.add_argument("--maxBatch", type=int, default=32,
                   help="micro-batcher flush size (throughput trigger)")
    p.add_argument("--maxWaitMs", type=float, default=5.0,
                   help="oldest-row age that forces a flush")
    p.add_argument("--maxQueue", type=int, default=256,
                   help="queued /predict rows beyond this get HTTP 429")
    p.add_argument("--slots", type=int, default=4,
                   help="continuous-batching decode slots")
    p.add_argument("--kvPageTokens", default=None, metavar="N|auto",
                   help="paged KV cache of N-token pages (N divides the "
                        "context length); 'auto' asks the tuner's kv_pages "
                        "namespace under --autotune cached|measure, else "
                        "takes the first of 128, 64, 32, 256 that divides "
                        "it. kv_cache_bytes then counts allocated pages")
    p.add_argument("--prefixCache", action="store_true",
                   help="share page-aligned prompt-prefix K/V across "
                        "requests (needs --kvPageTokens): a hit copies "
                        "pages and prefills only the suffix")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="speculative decoding: a draft LM proposes K tokens "
                        "a round and the target verifies them in one "
                        "chunked step (greedy output is --speculate 0's, "
                        "token for token); the draft is the target itself "
                        "unless --draftDims gives a smaller one")
    p.add_argument("--draftDims", default=None,
                   metavar="DMODEL,LAYERS,HEADS",
                   help="dims of a draft LM for --speculate, its weights "
                        "drawn from a seeded generator (only the accept "
                        "rate depends on them)")
    p.add_argument("--quantize", default="off", choices=QUANTIZE_CHOICES,
                   help="int8/fp8 weights (per-channel symmetric, the "
                        "dequant folded into each product); kv8 keeps the "
                        "paged KV pools in int8 with a scale a row (picks "
                        "a page size when --kvPageTokens is not given). "
                        "The greedy agreement and logit error against the "
                        "full-precision model are stamped into provenance")
    p.add_argument("--maxWaiting", type=int, default=64,
                   help="/generate requests that may wait for a slot "
                        "before 429")
    p.add_argument("--seq", type=int, default=None,
                   help="override the LM context length (max_len)")
    p.add_argument("--classes", type=int, default=1000,
                   help="class count of an image model")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations (an image model: the input cast; "
                        "an LM: after the embedding, and a bf16 KV cache); "
                        "parameters stay f32")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every /predict bucket at startup on "
                        "the CPU (on the card their graphs are captured "
                        "at startup all the same)")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="per-request wall timeout (503 past it)")
    p.add_argument("--deadlineMs", type=float, default=None,
                   help="default per-request deadline: requests still "
                        "queued past it are answered 504")
    p.add_argument("--shedAt", type=float, default=0.75,
                   help="past this fraction of queue capacity /generate "
                        "sheds with 429 while /predict keeps admitting")
    p.add_argument("--watchdogStallS", type=float, default=30.0,
                   help="a worker busy with no heartbeat this long is "
                        "declared wedged: 503s and /readyz 503")
    p.add_argument("--faultPlan", default=None, metavar="SPEC|FILE",
                   help="seeded fault injection at the serving sites "
                        "(resilience.faults), e.g. 'worker_kill@infer:3' "
                        "kills the batcher's worker on its 3rd forward; "
                        "no-op unless set")
    p.add_argument("--reqTrace", choices=("on", "off"), default="off",
                   help="per-request lifecycle tracing: request ids through "
                        "batcher, engine and decoder, server-side TTFT/TPOT/"
                        "ITL and queue/prefill/decode histograms, the "
                        "flight recorder behind /debug/requests")
    p.add_argument("--reqTraceCapacity", type=int, default=1024,
                   metavar="N",
                   help="completed-request records the flight recorder "
                        "keeps (the oldest dropped and counted past it)")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="server-side latency SLOs, e.g. 'ttft=200,tpot=30' "
                        "(ms; optional burn=FRAC,window=N): violation "
                        "counters, goodput, and a saturated burn rate sheds "
                        "/generate. Implies --reqTrace on")
    p.add_argument("--accessLog", default=None, metavar="FILE",
                   help="append one JSON line per completed request. "
                        "Implies --reqTrace on")
    p.add_argument("--logSample", type=float, default=1.0, metavar="P",
                   help="access-log sampling probability in [0, 1], "
                        "decided by a hash of the request id")
    p.add_argument("--vocabSize", type=int, default=None,
                   help="build a custom-dims LM (with --dModel/--numLayers/"
                        "--numHeads/--seq) instead of a zoo config")
    p.add_argument("--dModel", type=int, default=128)
    p.add_argument("--numLayers", type=int, default=2)
    p.add_argument("--numHeads", type=int, default=4)
    p.add_argument("--strategy", default=None,
                   metavar="tp[:K]|dp[:N]|dp:N+tp:K",
                   help="serving topology: tp:K shards one engine over the "
                        "K ranks of a torchrun job (rank 0 serves HTTP, the "
                        "others follow; the programs run eagerly), dp:N "
                        "runs N engine replicas in this process behind "
                        "least-load routing, one a device of --devices; "
                        "dp:N+tp:K: each of the K ranks holds its shard of "
                        "all N replicas (a process group a replica), rank 0 "
                        "routes")
    p.add_argument("--devices", default=None, metavar="LIST",
                   help="comma-separated devices the dp replicas take in "
                        "order, one may repeat (cuda:0,cuda:0 puts two "
                        "replicas on one card). Default: every visible "
                        "card; with --platform cpu, the CPU once a "
                        "replica")
    add_autotune_arg(p)
    add_fused_bn_arg(p)
    add_conv_args(p)
    add_lint_arg(p)
    return p


def _lint_exit(report, args, leader: bool) -> None:
    """Print one pre-flight report (on the leader rank) and refuse to
    serve under ``--lint=strict`` on an error."""
    from bigdl_tpu_torch.cli.common import run_preflight_lint

    rc, _ = run_preflight_lint(report, strict=(args.lint == "strict"),
                               quiet=not leader)
    if rc:
        raise SystemExit(rc)


def _tp_lint(args, model, mesh, leader: bool) -> None:
    """The tp placement rule over the whole model before it is split: a
    >= 1 MiB weight the Megatron pairing leaves whole runs on every
    rank."""
    from bigdl_tpu_torch.analysis import run_serving_tp_rules
    from bigdl_tpu_torch.parallel.tensor_parallel import param_tree
    from bigdl_tpu_torch.serving.sharding import ServingSharding

    _lint_exit(run_serving_tp_rules(
        param_tree(model), mesh.size,
        specs=ServingSharding(mesh).param_specs(model)), args, leader)


def _request_tracer(args, metrics):
    """The request tracer ``--reqTrace``/``--slo``/``--accessLog`` ask
    for, or None (an asked-for SLO or access log needs the tracer they
    read)."""
    from bigdl_tpu_torch.serving import reqtrace as _reqtrace

    if not (args.reqTrace == "on" or args.slo is not None
            or args.accessLog is not None):
        return None
    slo = access_log = None
    if args.slo is not None:
        try:
            slo = _reqtrace.SloPolicy.parse(args.slo)
        except ValueError as e:
            raise SystemExit(f"--slo {args.slo!r}: {e}")
    if not 0.0 <= args.logSample <= 1.0:
        raise SystemExit(f"--logSample {args.logSample} must be in [0, 1]")
    if args.reqTraceCapacity < 1:
        raise SystemExit(f"--reqTraceCapacity {args.reqTraceCapacity} "
                         f"must be >= 1")
    if args.accessLog is not None:
        access_log = _reqtrace.AccessLog(args.accessLog,
                                         sample=args.logSample)
    return _reqtrace.RequestTracer(capacity=args.reqTraceCapacity,
                                   metrics=metrics, slo=slo,
                                   access_log=access_log)


def _page_tokens(spec, max_len: int, kv_heads: int = 0, head_dim: int = 0,
                 dtype=None):
    """``--kvPageTokens``: None (dense), an int that divides ``max_len``,
    or 'auto': the tuner's ``kv_pages`` decision for the cache geometry
    under ``--autotune cached|measure``, else the JAX package's ladder
    (128, 64, 32, 256, the first that divides; dense if none does)."""
    if not spec:
        return None
    if str(spec).lower() == "auto":
        from bigdl_tpu_torch import tuning
        pt = tuning.kv_page_tokens(max_len, kv_heads, head_dim,
                                   dtype or "float32")
        if pt is not None:
            return pt
        return next((c for c in (128, 64, 32, 256)
                     if c <= max_len and max_len % c == 0), None)
    try:
        pt = int(spec)
    except ValueError:
        raise SystemExit(f"--kvPageTokens {spec!r}: expected an int or "
                         f"'auto'")
    if pt < 1 or max_len % pt:
        raise SystemExit(f"--kvPageTokens {pt} must divide the context "
                         f"length {max_len}")
    return pt


def _build_image_app(args, name, device, metrics, graphs, mesh=None,
                     first=True):
    """(engine, batcher, input shape, provenance, link) of an image
    classifier: its ``/predict`` buckets captured at the model's input
    shape. With ``mesh`` (a tp replica's) the model is split by
    ``megatron_specs``' conv rule on this rank and the engine, eager, runs
    rank 0's forwards on every rank through its ``TPLink``; a follower
    rank gets no batcher. The ``first`` replica runs the ``--lint``
    pre-flight."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.cli.common import apply_fused_bn, load_trained
    from bigdl_tpu_torch.cli.perf import IMAGE_CONFIGS, build_model
    from bigdl_tpu_torch.serving import InferenceEngine, MicroBatcher
    from bigdl_tpu_torch.serving.quant import parse_quantize

    if name not in IMAGE_CONFIGS:
        raise SystemExit(f"model {name}: serve takes the transformer_lm* "
                         f"rows and the image rows {sorted(IMAGE_CONFIGS)}")
    _, kv8 = parse_quantize(args.quantize)
    if kv8:
        raise SystemExit("--quantize kv8 quantizes the decode KV cache: "
                         "transformer_lm models only")
    for flag, val in (("--speculate", args.speculate),
                      ("--kvPageTokens", args.kvPageTokens),
                      ("--prefixCache", args.prefixCache)):
        if val:
            raise SystemExit(f"{flag}: decoding flags apply to "
                             f"transformer_lm models only")
    model, in_shape = build_model(name, class_num=args.classes)
    apply_fused_bn(model, args.fusedBN)
    if args.checkpoint:
        load_trained(model, args.checkpoint)
    link = None
    leader = mesh is None or mesh.rank == 0
    if mesh is not None:
        from bigdl_tpu_torch.serving.sharding import ServingSharding, TPLink
        if args.lint and first:
            _tp_lint(args, model, mesh, leader)
        ServingSharding(mesh).place_params(model.to(device))
        link = TPLink(mesh)
    engine = InferenceEngine(
        model, buckets=_parse_buckets(args.buckets), metrics=metrics,
        device=device, graphs=graphs, quantize=args.quantize,
        compute_dtype=torch.bfloat16 if args.bf16 else None, tp=link,
        lint=args.lint if first else None)
    rc = engine.preflight_lint(in_shape, np.float32, quiet=not leader)
    if rc:
        raise SystemExit(rc)
    if graphs.enabled or not args.no_warmup:
        print(f"warmup: buckets {engine.buckets} at {tuple(in_shape)} "
              f"float32", flush=True)
        engine.warmup(in_shape, np.float32)
    prov = {"classes": args.classes, "fused_bn": args.fusedBN or "off",
            "in_shape": ",".join(str(d) for d in in_shape)}
    if link is not None and not link.leader:
        return engine, None, in_shape, prov, link
    batcher = MicroBatcher(engine.predict_scores, max_batch=args.maxBatch,
                           max_wait_ms=args.maxWaitMs,
                           max_queue=args.maxQueue, metrics=metrics)
    return engine, batcher, in_shape, prov, link


def build_app(args):
    """(app, engine, in_shape, in_dtype) from parsed args. ``--autotune``,
    ``--convGeom`` and ``--convLayout`` are installed first, before the
    model is built. Every graph is captured (the /predict buckets, at
    each length bucket for an LM; the decode programs) before the
    server's workers (decoder loop, batcher, watchdog) are started. The
    request tracer (or None) is installed process-wide, and the app's
    metrics become the process registry; ``main`` installs
    ``--faultPlan`` before it calls this."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.cli.common import (apply_autotune, apply_conv_args,
                                            apply_fused_bn, load_trained,
                                            resolve_serve_config)
    from bigdl_tpu_torch.cli.perf import build_model
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.obs.metrics import set_registry
    from bigdl_tpu_torch.ops.attention_kernel import (SUPPORTED_HEAD_DIMS,
                                                      serving_prefill_buckets)
    from bigdl_tpu_torch.serving import (DecodeEngine, InferenceEngine,
                                         MetricsRegistry, MicroBatcher,
                                         ServingApp, Watchdog)
    from bigdl_tpu_torch.serving import reqtrace as _reqtrace
    from bigdl_tpu_torch.serving.graphs import GraphPool
    from bigdl_tpu_torch.serving.quant import (parse_quantize, quant_report,
                                               quantize_params, weight_bytes)
    from bigdl_tpu_torch.serving.spec_decode import parse_draft_dims

    cfg = resolve_serve_config(args)  # checks the serving flags first
    apply_autotune(args)
    apply_conv_args(args)
    tuning.reset_decisions()
    metrics = MetricsRegistry()
    reqtracer = _request_tracer(args, metrics)
    device = resolve_device(args.platform)
    name = args.model
    if not (args.randomInit or args.checkpoint):
        raise SystemExit("serve needs weights: pass --model CKPT (a "
                         "checkpoint directory or file) or --randomInit")
    replicas, tp_k = cfg.serving_replicas, cfg.serving_tp
    meshes = [None] * replicas
    if tp_k > 1:
        from bigdl_tpu_torch.cli.common import _join, _world
        from bigdl_tpu_torch.serving.sharding import replica_meshes
        _join(args)
        if _world() != tp_k:
            raise SystemExit(
                f"serve --strategy {cfg.strategy} runs {tp_k} ranks, one "
                f"process a device: start them with torchrun "
                f"--nproc_per_node {tp_k} (this job has {_world()})")
        meshes = replica_meshes(replicas)
    devices = (_replica_devices(args, replicas, device, tp_k > 1)
               if replicas > 1 else [[device]])
    if not name.startswith("transformer_lm"):
        set_registry(metrics)
        _reqtrace.set_request_tracer(reqtracer)
        built = []
        for i in range(replicas):
            view = (metrics.labelled(replica=str(i)) if replicas > 1
                    else metrics)
            graphs = GraphPool(devices[i][0], enabled=meshes[i] is None)
            built.append(_build_image_app(args, name, devices[i][0], view,
                                          graphs, mesh=meshes[i],
                                          first=(i == 0)))
        links = [b[4] for b in built if b[4] is not None]
        if links and not links[0].leader:
            return (TPFollower(links, [b[0] for b in built]), built[0][0],
                    built[0][2], np.float32)
        reps = []
        for i, (engine, batcher, in_shape, extra, _) in enumerate(built):
            watchdog = Watchdog(stall_timeout_s=args.watchdogStallS,
                                metrics=(metrics.labelled(replica=str(i))
                                         if replicas > 1 else metrics))
            watchdog.watch("batcher", batcher).start()
            reps.append((engine, batcher, watchdog))
        engine, batcher, watchdog = reps[0]
        in_shape, extra = built[0][2], built[0][3]
        rep_set = None
        if replicas > 1:
            from bigdl_tpu_torch.serving import Replica, ReplicaSet
            rep_set = ReplicaSet(
                [Replica(i, devices=devices[i], engine=e, batcher=b,
                         watchdog=w, mesh=meshes[i])
                 for i, (e, b, w) in enumerate(reps)], metrics=metrics)
        prov = _provenance(args, engine, reqtracer, name)
        prov.update(extra)
        prov["cuda_graphs"] = engine.graphs.enabled
        prov.update({"strategy": cfg.strategy or "none",
                     "serving_replicas": replicas, "serving_tp": tp_k})
        if rep_set is not None:
            app = ServingApp(name=name, metrics=metrics, replicas=rep_set,
                             request_timeout_s=args.timeout,
                             default_deadline_ms=args.deadlineMs,
                             shed_generate_frac=args.shedAt,
                             version=args.modelVersion or "v0",
                             tp_link=links or None)
        else:
            app = ServingApp(name=name, metrics=metrics, engine=engine,
                             batcher=batcher,
                             request_timeout_s=args.timeout,
                             default_deadline_ms=args.deadlineMs,
                             shed_generate_frac=args.shedAt,
                             watchdog=watchdog,
                             version=args.modelVersion or "v0",
                             tp_link=links or None)
        prov["model_version"] = lambda: app.model_version
        metrics.set_provenance(prov)
        return app, engine, in_shape, np.float32
    if args.vocabSize is not None:
        seq = args.seq or 128
        model = TransformerLM(args.vocabSize, d_model=args.dModel,
                              num_layers=args.numLayers,
                              num_heads=args.numHeads, max_len=seq,
                              attn_impl="flash",
                              generator=torch.Generator().manual_seed(0))
        in_shape = (seq,)
    else:
        model, in_shape = build_model(name, seq_len=args.seq)
    apply_fused_bn(model, args.fusedBN)
    if args.checkpoint:
        load_trained(model, args.checkpoint)
    draft = None
    if args.speculate < 0:
        raise SystemExit(f"--speculate {args.speculate} must be >= 0")
    if args.draftDims and args.speculate:
        try:
            dims = parse_draft_dims(args.draftDims)
        except ValueError as e:
            raise SystemExit(str(e))
        draft = TransformerLM(model.vocab, max_len=model.max_len,
                              attn_impl="flash",
                              generator=torch.Generator().manual_seed(1),
                              **dims)
    for m, what in ((model, "--dModel / --numHeads"), (draft, "--draftDims")):
        head_dim = m.encoder[0].mha.head_dim if m is not None else None
        if device.type == "cuda" and head_dim not in (None,) \
                + SUPPORTED_HEAD_DIMS:
            raise SystemExit(f"head_dim {head_dim} ({what}): the CUDA "
                             f"flash kernel takes {SUPPORTED_HEAD_DIMS}")
    wfmt, kv8 = parse_quantize(args.quantize)
    mha = model.encoder[0].mha
    page_tokens = _page_tokens(
        args.kvPageTokens, model.max_len, mha.num_kv_heads, mha.head_dim,
        torch.bfloat16 if args.bf16 else torch.float32)
    if kv8 and page_tokens is None:
        # kv8 is a page-pool layout: pick a page size
        page_tokens = next((c for c in _KV8_PAGES
                            if model.max_len % c == 0), None)
        if page_tokens is None:
            raise SystemExit(f"--quantize {args.quantize}: no page size in "
                             f"{_KV8_PAGES} divides max_len {model.max_len}; "
                             f"pass --kvPageTokens")
    if args.prefixCache and page_tokens is None:
        raise SystemExit("--prefixCache needs --kvPageTokens (prefix "
                         "sharing is a page copy)")
    compute_dtype = torch.bfloat16 if args.bf16 else None
    model.compute_dtype = compute_dtype
    model = model.to(device)
    quant_info = None
    if args.quantize != "off":
        # quantize once, and measure the quality against the
        # full-precision model while it is still here; the engines find
        # nothing left to quantize
        qmodel = quantize_params(model, wfmt)
        quant_info = quant_report(
            model, qmodel, prompt=list(range(1, min(9, model.vocab))),
            max_new_tokens=8, kv8=kv8, cache_dtype=compute_dtype)
        model = qmodel
    if draft is not None:
        draft.compute_dtype = compute_dtype
    leader = meshes[0] is None or meshes[0].rank == 0
    lint_prov = {}
    if args.lint:
        # the decode surface of the first replica (every replica runs the
        # same graph on an isomorphic tp group), before anything is split
        # or dispatched; the mesh it vetted goes into the provenance
        from bigdl_tpu_torch.analysis import lint_serving
        if tp_k > 1:
            _tp_lint(args, model, meshes[0], leader)
        _lint_exit(lint_serving(
            model, slots=args.slots, kv_page_tokens=page_tokens,
            speculate=args.speculate, quantize=args.quantize, tp=tp_k,
            mesh=meshes[0], cache_dtype=compute_dtype), args, leader)
        vetted = f"model:{tp_k}" if tp_k > 1 else (
            "replicated" if replicas > 1 else "single-device")
        lint_prov["lint_mesh"] = (f"{vetted} x {replicas} replica(s)"
                                  if replicas > 1 else vetted)

    # the fault and retry counters land on this server's page
    set_registry(metrics)
    _reqtrace.set_request_tracer(reqtracer)
    def placed(i):
        """(model, draft, link) of replica ``i`` on its device: the model
        itself for one replica, else a copy; split over replica ``i``'s
        mesh under tp."""
        import copy

        dev = devices[i][0]
        mdl = model if replicas == 1 else copy.deepcopy(model)
        drf = draft if replicas == 1 or draft is None else \
            copy.deepcopy(draft)
        mdl = mdl.to(dev)
        drf = drf.to(dev) if drf is not None else None
        if meshes[i] is None:
            return mdl, drf, None
        from bigdl_tpu_torch.serving.sharding import ServingSharding, TPLink
        sharding = ServingSharding(meshes[i])
        sharding.place_params(mdl)
        if drf is not None:
            sharding.place_params(drf)
        return mdl, drf, TPLink(meshes[i])

    def stack(dev, view, mdl, drf, link, first):
        """(engine, decoder, batcher, watchdog, graphs) of one engine on
        ``dev``, its series on ``view``; the ``first`` runs the forward's
        ``--lint`` pre-flight."""
        graphs = GraphPool(dev, enabled=link is None)
        # the LM is causal: /predict rows pad to the prompt ladder's
        # lengths
        engine = InferenceEngine(mdl, buckets=_parse_buckets(args.buckets),
                                 lengths=serving_prefill_buckets(
                                     mdl.max_len),
                                 metrics=view, device=dev, graphs=graphs,
                                 quantize=args.quantize, tp=link,
                                 lint=args.lint if first else None)
        rc = engine.preflight_lint(in_shape, np.int32, quiet=not leader)
        if rc:
            raise SystemExit(rc)
        if graphs.enabled or not args.no_warmup:
            print(f"warmup: buckets {engine.buckets} at lengths "
                  f"{engine.lengths} int32", flush=True)
            engine.warmup(in_shape, np.int32)
        decoder = DecodeEngine(mdl, slots=args.slots,
                               cache_dtype=compute_dtype,
                               max_waiting=args.maxWaiting, metrics=view,
                               device=dev, kv_page_tokens=page_tokens,
                               prefix_cache=args.prefixCache,
                               speculate=args.speculate, draft_model=drf,
                               quantize=args.quantize, graphs=graphs,
                               tp=link)
        if link is not None and not link.leader:
            return engine, decoder, None, None, graphs
        batcher = MicroBatcher(engine.predict_scores,
                               max_batch=args.maxBatch,
                               max_wait_ms=args.maxWaitMs,
                               max_queue=args.maxQueue, metrics=view)
        decoder.start()
        watchdog = Watchdog(stall_timeout_s=args.watchdogStallS,
                            metrics=view)
        watchdog.watch("batcher", batcher).watch("decoder", decoder).start()
        return engine, decoder, batcher, watchdog, graphs

    stacks, links = [], []
    for i in range(replicas):
        mdl, drf, link = placed(i)
        if i == 0:
            served = mdl
        if link is not None:
            links.append(link)
        stacks.append(stack(devices[i][0],
                            (metrics.labelled(replica=str(i))
                             if replicas > 1 else metrics), mdl, drf, link,
                            i == 0))
    if links and not links[0].leader:
        return (TPFollower(links, [st[0] for st in stacks],
                           [st[1] for st in stacks]), stacks[0][0], in_shape,
                np.int32)
    engine, decoder, batcher, watchdog, graphs = stacks[0]
    rep_set = None
    if replicas > 1:
        from bigdl_tpu_torch.serving import Replica, ReplicaSet
        rep_set = ReplicaSet(
            [Replica(i, devices=devices[i], engine=e, batcher=b, decoder=d,
                     watchdog=w, mesh=meshes[i])
             for i, (e, d, b, w, _) in enumerate(stacks)], metrics=metrics)
        batcher = watchdog = None

    prov = _provenance(args, engine, reqtracer, name)
    prov.update(lint_prov)
    prov.update({
        "decode_slots": args.slots,
        "prompt_buckets": ",".join(str(b) for b in decoder.prompt_buckets),
        "kv_page_tokens": page_tokens or "dense",
        "prefix_cache": bool(args.prefixCache),
        "cuda_graphs": graphs.enabled,
        "speculate": args.speculate,
        "draft": (args.draftDims or "self") if args.speculate else "none",
        "weight_bytes": weight_bytes(served),
        "strategy": cfg.strategy or "none",
        "serving_replicas": replicas,
        "serving_tp": tp_k,
    })
    if quant_info is not None:
        prov["quant_agreement"] = round(float(quant_info["agreement"]), 4)
        prov["quant_logit_max_err"] = round(
            float(quant_info["logit_max_err"]), 6)
    if rep_set is not None:
        app = ServingApp(name=name, metrics=metrics, replicas=rep_set,
                         request_timeout_s=args.timeout,
                         default_deadline_ms=args.deadlineMs,
                         shed_generate_frac=args.shedAt,
                         version=args.modelVersion or "v0",
                         tp_link=links or None)
    else:
        app = ServingApp(name=name, metrics=metrics, engine=engine,
                         batcher=batcher, decoder=decoder,
                         request_timeout_s=args.timeout,
                         default_deadline_ms=args.deadlineMs,
                         shed_generate_frac=args.shedAt, watchdog=watchdog,
                         version=args.modelVersion or "v0",
                         tp_link=links or None)
    # resolved at each scrape: a rolling swap bumps the version
    prov["model_version"] = lambda: app.model_version
    metrics.set_provenance(prov)
    return app, engine, in_shape, np.int32


class TPFollower:
    """What ``build_app`` returns on ranks 1..K-1 of a tp:K server: its
    engines (one a replica under dp:N+tp:K), which :meth:`serve` runs at
    rank 0's calls, a thread a replica's link, until rank 0 closes."""

    follower = True

    def __init__(self, links, engines, decoders=()):
        self.links, self.engines = list(links), list(engines)
        self.decoders = list(decoders)
        # replica 0's, as on the leader's app
        self.engine = self.engines[0]
        self.decoder = self.decoders[0] if self.decoders else None

    def serve(self) -> int:
        """Run rank 0's calls until it closes every link; returns how many
        ran."""
        if len(self.links) == 1:
            return self.links[0].serve()
        import threading

        errors: list = []

        def follow(link):
            try:
                link.serve()
            except BaseException as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=follow, args=(link,),
                                    name=f"tp-follow-{i}", daemon=True)
                   for i, link in enumerate(self.links)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return sum(link.calls for link in self.links)

    def close(self) -> None:
        for d in self.decoders:
            d.close()
        for e in self.engines:
            e.close()


def _replica_devices(args, replicas: int, device, tp: bool = False) -> list:
    """The dp replicas' device groups: ``--devices`` in order, else every
    visible card, or this process's device once a replica under
    ``--platform cpu`` and under dp:N+tp:K (a rank's N shards)."""
    import torch

    from bigdl_tpu_torch.serving.sharding import replica_device_groups
    if args.devices:
        devices = [torch.device(d.strip()) for d in args.devices.split(",")
                   if d.strip()]
    elif device.type == "cpu" or tp:
        devices = [device] * replicas
    else:
        devices = None
    try:
        return replica_device_groups(replicas, 1, devices)
    except ValueError as e:
        raise SystemExit(f"--strategy {args.strategy}: {e} (name "
                         f"them with --devices, e.g. cuda:0,cuda:0)")


def _provenance(args, engine, reqtracer, name) -> dict:
    """The provenance every served model stamps into /metrics: the
    engine's, the batcher's bounds, the weights, the tracer's settings,
    the fault plan; the engine's carries the shared core (the tuner's
    mode among it)."""
    prov = engine.provenance()
    prov.update({
        "model": name,
        "weights": args.checkpoint or "random (seed 0)",
        "max_batch": args.maxBatch,
        "max_wait_ms": args.maxWaitMs,
        "max_queue": args.maxQueue,
        "deadline_ms": args.deadlineMs if args.deadlineMs else "none",
        "shed_at": args.shedAt,
        "reqtrace": "on" if reqtracer is not None else "off",
    })
    if reqtracer is not None:
        prov["slo"] = args.slo or "none"
        if reqtracer.access_log is not None:
            prov["access_log"] = reqtracer.access_log.path
            prov["access_log_sample"] = args.logSample
    if args.faultPlan:
        prov["fault_plan"] = args.faultPlan
    return prov


def main(argv=None) -> int:
    import sys

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    raw_argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(raw_argv)
    if args.fleet:
        # this process becomes the router; each worker enters the serve
        # stack in its own process, the router's flags stripped
        from bigdl_tpu_torch.serving.fleet.router import run_fleet
        return run_fleet(args, raw_argv)
    from bigdl_tpu_torch.cli.common import install_fault_plan
    from bigdl_tpu_torch.serving.server import run_server

    install_fault_plan(args)
    app, _, _, _ = build_app(args)
    if getattr(app, "follower", False):
        # ranks 1..K-1 of a tp:K server: rank 0's calls until it closes
        try:
            app.serve()
            return 0
        finally:
            app.close()
    return run_server(app, args.host, args.port)


if __name__ == "__main__":
    raise SystemExit(main())
