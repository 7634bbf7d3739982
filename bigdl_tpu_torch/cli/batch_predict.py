"""Offline bulk inference over record shards (counterpart of
``bigdl_tpu/cli/batch_predict.py``; the analog of BigDL's RDD batch
scoring, ``model.predict(rdd)``, arxiv 1804.05839 §3), by composition:
the ``dataset/pipeline`` executor feeds the serving engine's bucketed
forwards, and a cursor checkpoint makes kill and resume byte-identical::

    python -m bigdl_tpu_torch.cli.batch_predict --modelName resnet50 \\
        --model CKPT -f record:/data/shards --out /data/scores -b 128 \\
        --dataWorkers 8 --stage device --strategy dp:2 \\
        --devices cuda:0,cuda:1

* the record feed is the training input pipeline in eval mode
  (``shuffle=False``, deterministic resize and centre crop): N decode
  workers race the :class:`EpochPlan`'s tickets, batches come back in plan
  order, ``--stage device`` overlaps the copy to the card with scoring;
* ``--strategy dp[:N]`` deals the batch stream round-robin to N engine
  replicas, one a device of ``--devices`` (the ``serve`` spelling:
  ``cuda:0,cuda:0`` puts two on one card); ``tp:K`` runs each replica
  tensor-parallel over the K ranks of a torchrun job (rank 0 feeds and
  writes, the others follow, eagerly); ``dp:N+tp:K`` combines them, each
  rank holding its shard of all N replicas;
* outputs append to sharded JSONL (``scores-XXXXX-of-NNNNN.jsonl``, the
  global order back by sorting on ``"i"``), with a cursor every
  ``--checkpointEvery`` batches (``serving/bulk.py``), so a killed job
  resumes with no record scored twice or dropped;
* the report line carries the training perf line's phase and provenance
  columns (``stall_frac``, ``data_wait_s``, ``pipeline``, the memory
  columns under ``--obs``) and ``images_per_second_per_chip``.

The tail (the ``n % batch`` records a training plan drops) is scored as
one padded batch, so every record is scored. Each replica is an
:class:`~bigdl_tpu_torch.serving.engine.InferenceEngine` whose batch
buckets (powers of two up to ``-b``) are CUDA graphs on the card. Weights
come from ``--model`` (a checkpoint of the port or the JAX package) or
``--randomInit`` (the port's seeded draw, not the JAX package's).
"""

from __future__ import annotations

import argparse
import json
import time

from bigdl_tpu_torch.cli import common

__all__ = ["build_parser", "build_engines", "main"]

MODEL_NAMES = ("alexnet", "inception_v1", "inception_v2", "vgg16", "vgg19",
               "resnet50", "resnet20_cifar", "vit_b16", "vit_s16")
# the perf harness's record recipe (ImageNet statistics in 0-255 units)
RECORD_MEAN = (123.68, 116.779, 103.939)
RECORD_STD = (58.4, 57.1, 57.4)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.cli.batch_predict")
    p.add_argument("--modelName", default="resnet50", choices=MODEL_NAMES,
                   help="image model (cli/perf.py build table); sets the "
                        "eval crop geometry")
    p.add_argument("--model", default=None,
                   help="trained checkpoint dir (newest model.<n>) or "
                        "single saved file, the port's or the JAX "
                        "package's")
    p.add_argument("--randomInit", action="store_true",
                   help="random weights (the port's seeded draw) instead "
                        "of --model (throughput smoke)")
    p.add_argument("-f", "--folder", required=True,
                   help="record:<dir> (or plain dir/glob) of .btr record "
                        "shards to score")
    p.add_argument("--out", required=True,
                   help="output dir: scores-*.jsonl shards + cursor.json "
                        "(an existing cursor resumes the job)")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--limit", type=int, default=None, metavar="N",
                   help="score only the first N records of the plan order")
    p.add_argument("--scores", action="store_true",
                   help="emit full score vectors per record, not just the "
                        "argmax pred")
    p.add_argument("--checkpointEvery", type=int, default=32, metavar="K",
                   help="drain + fsync + cursor write every K dispatched "
                        "batches (the resume granularity)")
    p.add_argument("--strategy", default=None,
                   metavar="dp[:N]|tp[:K]|dp:N+tp:K",
                   help="device fan-out, serve spellings: dp[:N] = N "
                        "engine replicas fed round-robin, one a device of "
                        "--devices; tp[:K] = each replica tensor-parallel "
                        "over the K ranks of a torchrun job; dp:N+tp:K "
                        "combines. Default: one engine")
    p.add_argument("--devices", default=None, metavar="LIST",
                   help="comma-separated devices the dp replicas take in "
                        "order, one may repeat (cuda:0,cuda:0 puts two "
                        "replicas on one card). Default: every visible "
                        "card; with --platform cpu, or under tp, this "
                        "process's device once a replica")
    common.add_pipeline_args(p)
    common._add_platform_arg(p)
    common.add_autotune_arg(p)
    common.add_fused_bn_arg(p)
    common.add_obs_args(p)
    return p


def _build_feed(args, crop, device):
    """The eval-mode executor feed and its provenance: record source ->
    StreamingSampleSource -> EpochPlan(shuffle=False) -> ExecutorDataSet
    [-> StagedDataSet]. Returns ``(feed_iter, plan, n, sig, pipeline)``
    where ``feed_iter`` yields ``(ordinal, indices, x)``, the tail's
    partial batch last."""
    import numpy as np

    from bigdl_tpu_torch.cli.perf import _short_side
    from bigdl_tpu_torch.dataset.pipeline import (EpochPlan, ExecutorDataSet,
                                                  StagedDataSet,
                                                  StreamingSampleSource)
    from bigdl_tpu_torch.dataset.pipeline.staging import DeviceBatch
    from bigdl_tpu_torch.dataset.streaming import RecordImageDataSet

    source = args.folder
    if source.startswith("record:"):
        source = source[len("record:"):]
    batch = args.batchSize
    # the perf harness's record recipe, eval mode: deterministic resize
    # and centre crop (train=False), so scores reproduce run to run
    rds = RecordImageDataSet(
        source, batch_size=batch, crop=crop, train=False,
        short_side=_short_side(crop), mean=list(RECORD_MEAN),
        std=list(RECORD_STD), n_threads=1, window=1)
    src = StreamingSampleSource(rds)
    n = len(src)
    if args.limit is not None:
        n = min(n, int(args.limit))
    if n <= 0:
        raise SystemExit(f"no records to score under {source}")
    plan = EpochPlan(n, batch, seed=0, shuffle=False,
                     process_index=0, process_count=1)
    workers = max(1, int(args.dataWorkers or 0))
    depth = max(1, int(args.prefetchDepth or 2))
    ds = ExecutorDataSet(src, workers=workers, depth=depth, plan=plan)
    staged = ds
    if args.stage != "off":
        staged = StagedDataSet(ds, stage=args.stage, depth=depth,
                               device=device)
    pipeline_sig = staged.signature()

    batch_rows = plan.batch_indices(0)  # (steps, batch) plan-order rows

    def feed():
        s = 0
        for mb in staged:
            if s >= plan.steps:
                break
            # a staged batch: the scoring stream waits for its copy
            x = mb.claim()[0] if isinstance(mb, DeviceBatch) else mb.input
            yield s, batch_rows[s], x
            s += 1
        # the plan drops n % batch for training lockstep; bulk scoring
        # covers every record: the tail is one partial batch (the engine
        # pads it to a bucket)
        tail = np.arange(plan.steps * plan.global_batch, n)
        if len(tail):
            mb = src.collate([src.load(int(i), 0) for i in tail])
            yield plan.steps, tail, mb.input

    return feed(), plan, n, src.signature(), pipeline_sig


def build_engines(args, device):
    """``(model, input shape, engines, links, replicas, tp_k)``: one
    :class:`InferenceEngine` a replica of ``--strategy`` (serve's
    grammar), each on its device, graphed on the card; under tp each
    replica's model is split over its own mesh and ``links`` holds this
    rank's ``TPLink`` of each replica (empty otherwise)."""
    import copy

    import numpy as np

    from bigdl_tpu_torch.cli.common import (_virtual_serving_devices,
                                            parse_serving_strategy)
    from bigdl_tpu_torch.cli.perf import build_model
    from bigdl_tpu_torch.cli.serve import _replica_devices
    from bigdl_tpu_torch.serving import InferenceEngine, power_of_two_buckets
    from bigdl_tpu_torch.serving.graphs import GraphPool

    spec = args.strategy
    replicas, tp_k = parse_serving_strategy(
        spec, _virtual_serving_devices(spec))
    meshes = [None] * replicas
    if tp_k > 1:
        from bigdl_tpu_torch.serving.sharding import replica_meshes
        common._join(args)
        if common._world() != tp_k:
            raise SystemExit(
                f"batch-predict --strategy {spec} runs {tp_k} ranks, one "
                f"process a device: start them with torchrun "
                f"--nproc_per_node {tp_k} (this job has {common._world()})")
        meshes = replica_meshes(replicas)
    devices = (_replica_devices(args, replicas, device, tp_k > 1)
               if replicas > 1 else [[device]])

    model, size = build_model(args.modelName, class_num=args.classNum)
    common.apply_fused_bn(model, getattr(args, "fusedBN", None))
    if not args.randomInit:
        common.load_trained(model, args.model)
    engines, links = [], []
    for i in range(replicas):
        dev = devices[i][0]
        mdl = (model if replicas == 1 else copy.deepcopy(model)).to(dev)
        link = None
        if meshes[i] is not None:
            from bigdl_tpu_torch.serving.sharding import (ServingSharding,
                                                          TPLink)
            ServingSharding(meshes[i]).place_params(mdl)
            link = TPLink(meshes[i])
            links.append(link)
        eng = InferenceEngine(mdl, buckets=power_of_two_buckets(
            args.batchSize), device=dev,
            graphs=GraphPool(dev, enabled=link is None), tp=link)
        if eng.graphs.enabled:
            eng.warmup(size, np.float32)  # every bucket's graph, up front
        engines.append(eng)
    return model, size, engines, links, replicas, tp_k


def main(argv=None):
    common.setup_logging()
    args = build_parser().parse_args(argv)
    if not args.randomInit and not args.model:
        raise SystemExit("need --model CKPT (or --randomInit for a "
                         "throughput smoke)")
    common.apply_platform(args)
    common.apply_autotune(args)

    from bigdl_tpu_torch.cli.perf import _annotate_obs_phases
    from bigdl_tpu_torch.cli.provenance import provenance_dict
    from bigdl_tpu_torch.cli.serve import TPFollower
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.serving import bulk

    device = resolve_device(args.platform)
    model, size, engines, links, replicas, tp_k = build_engines(args, device)
    if links and not links[0].leader:
        # ranks 1..K-1: rank 0's forwards until it closes
        follower = TPFollower(links, engines)
        try:
            follower.serve()
        finally:
            follower.close()
        return None
    try:
        crop = tuple(size[:2])
        feed, plan, n, src_sig, pipeline_sig = _build_feed(args, crop,
                                                           device)
        # the resume identity: the exact plan, source and scoring config;
        # any drift refuses to resume instead of silently rescoring
        signature = {"plan": plan.signature(), "src": src_sig,
                     "model": args.modelName,
                     "class_num": int(args.classNum),
                     "scores": bool(args.scores), "groups": len(engines),
                     "tp": int(tp_k)}

        prior = bulk.load_cursor(args.out)
        records_prior = int(prior.get("records_done", 0)) if prior else 0

        obs_state = getattr(args, "_obs", None)
        phase: dict = {}
        t0 = time.perf_counter()
        rep = bulk.run_bulk(engines, feed, signature, args.out,
                            scores=args.scores,
                            checkpoint_every=args.checkpointEvery,
                            phase=phase)
        wall = time.perf_counter() - t0
    finally:
        for link in links:
            link.close()  # the followers return
        for eng in engines:
            eng.close()

    n_chips = replicas * max(1, tp_k)
    scored = max(0, rep["records"] - records_prior)
    out = {"bench": "batch_predict", "model": args.modelName,
           "batch": args.batchSize, "records": rep["records"],
           "records_scored_this_run": scored,
           "batches": rep["batches"],
           "resumed_from_batch": rep["resumed_from_batch"],
           "groups": rep["groups"], "tp": tp_k, "chips": n_chips,
           "shards": rep["shards"], "seconds": round(wall, 3),
           "images_per_second": (round(scored / wall, 2) if wall else None),
           "images_per_second_per_chip": (round(scored / wall / n_chips, 2)
                                          if wall else None),
           "pipeline": pipeline_sig}
    # the training perf line's schema-stable phase and provenance columns
    _annotate_obs_phases(out, obs_state, phase, wall)
    out.update(provenance_dict(model))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
