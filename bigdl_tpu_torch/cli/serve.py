"""Serve a transformer LM over HTTP on the GPU (counterpart of
``bigdl_tpu/cli/serve.py``)::

    python -m bigdl_tpu_torch.cli.serve transformer_lm_1k_hd128 --randomInit
    curl -d '{"tokens": [3, 1, 4], "max_new_tokens": 8}' \\
        localhost:8000/generate

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

``/generate`` with ``"stream": true`` answers in SSE frames.
``--reqTrace on`` traces every request's lifecycle (``/debug/requests``,
TTFT/TPOT/ITL histograms); ``--slo ttft=MS,tpot=MS`` and ``--accessLog
FILE`` (sampled by ``--logSample``) imply it. ``--faultPlan`` injects
seeded faults at the serving sites. ``--fleet K`` makes this process a
router in front of K worker processes (``serving.fleet``; the router
imports no torch), with ``--modelVersion``, ``--fleetHeartbeatS`` and
``--fleetRestartBudget``. Flags of features not ported yet are refused
with a message naming the ROADMAP.md entry that brings them, never
ignored.
"""

from __future__ import annotations

import argparse
import logging

from bigdl_tpu_torch.cli.common import QUANTIZE_CHOICES

__all__ = ["build_parser", "build_app", "main"]

# flags of the JAX package's serve that later slices of the port bring,
# and the ROADMAP.md queue 1 entry that brings each
_LATER_FLAGS = {
    "--strategy": "entry 13 (serving replicas and tensor-parallel "
                  "sharding)",
    "--classes": "entry 8's rest (the non-LM models behind serve)",
    "--fusedBN": "entry 8's rest (the non-LM models behind serve)",
    "--convLayout": "entry 8's rest (the non-LM models behind serve)",
    "--convGeom": "entry 8's rest (the non-LM models behind serve)",
    "--autotune": "entry 11 (tuning/)",
    "--lint": "entry 16 (analysis/)",
}
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
        description="online LM inference over HTTP on the GPU: bucketed "
                    "/predict, continuous-batching /generate, /metrics")
    p.add_argument("model", help="transformer_lm, transformer_lm_rope, "
                                 "transformer_lm_1k or transformer_lm_1k_hd128")
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
                        "context length); 'auto' takes the first of 128, "
                        "64, 32, 256 that divides it. kv_cache_bytes then "
                        "counts allocated pages")
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
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations after the embedding and a bf16 "
                        "KV cache; parameters stay f32")
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
    for flag in _LATER_FLAGS:
        p.add_argument(flag, dest=f"later_{flag[2:]}", nargs="?", const=True,
                       default=None, help=argparse.SUPPRESS)
    return p


def refuse_later_flags(args) -> None:
    """SystemExit naming each given flag the port does not have yet and
    the ROADMAP.md entry that brings it."""
    later = [f for f in _LATER_FLAGS
             if getattr(args, f"later_{f[2:]}", None) is not None]
    if later:
        raise SystemExit("; ".join(
            f"{f}: not available in the PyTorch port yet (ROADMAP.md "
            f"queue 1 {_LATER_FLAGS[f]} brings it)" for f in later))


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


def _page_tokens(spec, max_len: int):
    """``--kvPageTokens``: None (dense), an int that divides ``max_len``,
    or 'auto': the JAX package's ladder when autotune is off (128, 64, 32,
    256, the first that divides; dense if none does)."""
    if not spec:
        return None
    if str(spec).lower() == "auto":
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


def build_app(args):
    """(app, engine, in_shape, in_dtype) from parsed args. Every graph is
    captured (the /predict buckets at each length bucket, the decode
    programs) before the server's workers (decoder loop, batcher,
    watchdog) are started. The request tracer (or None) is installed
    process-wide, and the app's metrics become the process registry;
    ``main`` installs ``--faultPlan`` before it calls this."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.cli.common import load_trained, resolve_serve_config
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

    resolve_serve_config(args)  # refuses what is not ported first
    metrics = MetricsRegistry()
    reqtracer = _request_tracer(args, metrics)
    device = resolve_device(args.platform)
    name = args.model
    if not name.startswith("transformer_lm"):
        raise SystemExit(f"model {name}: only transformer_lm* models are "
                         f"served by the PyTorch port so far")
    if not (args.randomInit or args.checkpoint):
        raise SystemExit("serve needs weights: pass --model CKPT (a "
                         "checkpoint directory or file) or --randomInit")
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
    page_tokens = _page_tokens(args.kvPageTokens, model.max_len)
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

    # the fault and retry counters land on this server's page
    set_registry(metrics)
    _reqtrace.set_request_tracer(reqtracer)
    graphs = GraphPool(device)
    # the LM is causal: /predict rows pad to the prompt ladder's lengths
    engine = InferenceEngine(model, buckets=_parse_buckets(args.buckets),
                             lengths=serving_prefill_buckets(model.max_len),
                             metrics=metrics, device=device, graphs=graphs,
                             quantize=args.quantize)
    if graphs.enabled or not args.no_warmup:
        print(f"warmup: buckets {engine.buckets} at lengths "
              f"{engine.lengths} int32", flush=True)
        engine.warmup(in_shape, np.int32)
    decoder = DecodeEngine(model, slots=args.slots, cache_dtype=compute_dtype,
                           max_waiting=args.maxWaiting, metrics=metrics,
                           device=device, kv_page_tokens=page_tokens,
                           prefix_cache=args.prefixCache,
                           speculate=args.speculate, draft_model=draft,
                           quantize=args.quantize, graphs=graphs)
    batcher = MicroBatcher(engine.predict_scores, max_batch=args.maxBatch,
                           max_wait_ms=args.maxWaitMs,
                           max_queue=args.maxQueue, metrics=metrics)
    decoder.start()
    watchdog = Watchdog(stall_timeout_s=args.watchdogStallS, metrics=metrics)
    watchdog.watch("batcher", batcher).watch("decoder", decoder).start()

    prov = engine.provenance()
    prov.update({
        "model": name,
        "weights": args.checkpoint or "random (seed 0)",
        "max_batch": args.maxBatch,
        "max_wait_ms": args.maxWaitMs,
        "max_queue": args.maxQueue,
        "deadline_ms": args.deadlineMs if args.deadlineMs else "none",
        "shed_at": args.shedAt,
        "decode_slots": args.slots,
        "prompt_buckets": ",".join(str(b) for b in decoder.prompt_buckets),
        "kv_page_tokens": page_tokens or "dense",
        "prefix_cache": bool(args.prefixCache),
        "cuda_graphs": graphs.enabled,
        "speculate": args.speculate,
        "draft": (args.draftDims or "self") if args.speculate else "none",
        "weight_bytes": weight_bytes(model),
        "reqtrace": "on" if reqtracer is not None else "off",
    })
    if reqtracer is not None:
        prov["slo"] = args.slo or "none"
        if reqtracer.access_log is not None:
            prov["access_log"] = reqtracer.access_log.path
            prov["access_log_sample"] = args.logSample
    if args.faultPlan:
        prov["fault_plan"] = args.faultPlan
    if quant_info is not None:
        prov["quant_agreement"] = round(float(quant_info["agreement"]), 4)
        prov["quant_logit_max_err"] = round(
            float(quant_info["logit_max_err"]), 6)
    app = ServingApp(name=name, metrics=metrics, engine=engine,
                     batcher=batcher, decoder=decoder,
                     request_timeout_s=args.timeout,
                     default_deadline_ms=args.deadlineMs,
                     shed_generate_frac=args.shedAt, watchdog=watchdog,
                     version=args.modelVersion or "v0")
    # resolved at each scrape: a rolling swap bumps the version
    prov["model_version"] = lambda: app.model_version
    metrics.set_provenance(prov)
    return app, engine, in_shape, np.int32


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
    return run_server(app, args.host, args.port)


if __name__ == "__main__":
    raise SystemExit(main())
