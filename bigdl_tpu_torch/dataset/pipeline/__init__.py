"""The asynchronous input pipeline (counterpart of
``bigdl_tpu/dataset/pipeline/``): a pool of decode/augment worker threads
races an :class:`EpochPlan`'s sample tickets (:mod:`.executor`, the
reference's MTLabeledBGRImgToBatch model), a staging thread prepares the
next batch in pinned memory or on the card while the card runs the step
(:mod:`.staging`), and one plan object owns per-process epoch sharding
(:mod:`.plan`).

CLI surface: ``--dataWorkers N --prefetchDepth D --stage {off,host,
device}`` (``cli/common.build_feed``).
"""

import logging

from bigdl_tpu_torch.dataset.pipeline.executor import (ArraySampleSource,
                                                       ExecutorDataSet,
                                                       SampleSource,
                                                       StreamingSampleSource,
                                                       as_executor)
from bigdl_tpu_torch.dataset.pipeline.plan import (EpochPlan, process_rank,
                                                   sample_rng)
from bigdl_tpu_torch.dataset.pipeline.staging import (STAGE_CHOICES,
                                                      DeviceBatch,
                                                      StagedDataSet,
                                                      make_put_fn,
                                                      staged_batches)

__all__ = ["EpochPlan", "sample_rng", "process_rank", "SampleSource",
           "ArraySampleSource", "StreamingSampleSource", "ExecutorDataSet",
           "as_executor", "DeviceBatch", "StagedDataSet", "staged_batches",
           "make_put_fn", "STAGE_CHOICES", "wrap_pipeline"]

logger = logging.getLogger("bigdl_tpu_torch")


def wrap_pipeline(dataset, workers: int = 0, depth: int = 2,
                  stage: str = "off", seed: int = 0, device=None):
    """Wrap a training DataSet in the pipeline stack per the
    ``(--dataWorkers, --prefetchDepth, --stage)`` triple.

    Returns ``(dataset, provenance)``: provenance is None when the surface
    is untouched, else a dict of the choices (and the plan's signature
    when an executor runs). A dataset with no executor decomposition gets
    the single-threaded prefetch wrapper, so ``--dataWorkers`` still
    prepares batches ahead."""
    workers = int(workers or 0)
    depth = max(1, int(depth or 2))
    stage = stage or "off"
    if stage not in STAGE_CHOICES:
        raise ValueError(f"stage must be one of {STAGE_CHOICES}, "
                         f"got {stage!r}")
    if workers <= 0 and stage == "off":
        return dataset, None
    prov = {"workers": workers, "depth": depth, "stage": stage}
    ds = dataset
    if workers > 0:
        ex = as_executor(ds, workers=workers, depth=depth, seed=seed)
        if ex is None:
            logger.warning(
                "--dataWorkers: %s has no executor decomposition; using "
                "the single-threaded prefetch wrapper instead",
                type(ds).__name__)
            prov["executor"] = False
            if stage == "off":
                from bigdl_tpu_torch.dataset.prefetch import PrefetchDataSet
                ds = PrefetchDataSet(ds, depth)
        else:
            ds = ex
            prov["executor"] = True
            prov["plan"] = ex.plan.signature()
    if stage != "off":
        ds = StagedDataSet(ds, stage=stage, depth=depth, device=device)
    return ds, prov
