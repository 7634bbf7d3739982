"""The port's observability layer (counterpart of ``bigdl_tpu/obs``):

* :mod:`spans`   -- step-phase tracing (``span("data_wait")``),
  ring-buffered, near-zero cost disabled, Chrome-trace export;
* :mod:`metrics` -- the process-global registry (counters, gauges,
  histograms, the step-phase histograms, Prometheus exposition);
* :mod:`capture` -- ``torch.profiler`` windows mid-run (``--traceSteps
  N@M``, SIGUSR2, touch-file), verified with ``utils/kineto`` on close;
* :mod:`attrib`  -- device time by category over CUDA kernel names, the
  collective breakout and the MFU decomposition;
* :mod:`memory`  -- the memory plan, live allocator gauges, the fit
  forecast and the OOM autopsy;
* :mod:`http`    -- a live ``/metrics`` listener for training runs;
* :mod:`aggregate` -- the fleet router's merge of worker pages.

Wired as ``--obs``/``--traceDir``/``--traceSteps``/``--metricsPort`` on
``cli.perf`` and every training CLI (``cli/common.py``)."""

from bigdl_tpu_torch.obs import attrib, memory
from bigdl_tpu_torch.obs.attrib import (ATTRIB_CATEGORIES, attribute,
                                        attribute_profile, classify_op)
from bigdl_tpu_torch.obs.capture import (TOUCH_FILE_NAME, CaptureController,
                                         parse_trace_steps)
from bigdl_tpu_torch.obs.http import MetricsServer, start_metrics_server
from bigdl_tpu_torch.obs.memory import (HbmSampler, build_plan,
                                        device_hbm_bytes, forecast,
                                        handle_oom, is_resource_exhausted,
                                        plan_for_model, tree_bytes,
                                        write_oom_report)
from bigdl_tpu_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS_MS,
                                         ITL_BUCKETS_MS, PHASE_BUCKETS_MS,
                                         TRAIN_PHASES, Counter, Gauge,
                                         Histogram, MetricsRegistry,
                                         get_registry, phase_histograms,
                                         reset_registry, set_registry)
from bigdl_tpu_torch.obs.spans import (NOOP_SPAN, Tracer, counter, disable,
                                       enable, enabled, get_tracer, instant,
                                       set_tracer, span)

__all__ = [
    "attrib", "ATTRIB_CATEGORIES", "attribute", "attribute_profile",
    "classify_op",
    "CaptureController", "parse_trace_steps", "TOUCH_FILE_NAME",
    "MetricsServer", "start_metrics_server",
    "memory", "HbmSampler", "build_plan", "device_hbm_bytes", "forecast",
    "handle_oom", "is_resource_exhausted", "plan_for_model", "tree_bytes",
    "write_oom_report",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_MS", "ITL_BUCKETS_MS", "PHASE_BUCKETS_MS",
    "TRAIN_PHASES", "get_registry", "phase_histograms", "reset_registry",
    "set_registry",
    "NOOP_SPAN", "Tracer", "counter", "disable", "enable", "enabled",
    "get_tracer", "instant", "set_tracer", "span",
]
