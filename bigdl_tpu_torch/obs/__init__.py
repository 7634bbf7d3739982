from bigdl_tpu_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS_MS,
                                         ITL_BUCKETS_MS, Counter, Gauge,
                                         Histogram, MetricsRegistry,
                                         get_registry, reset_registry,
                                         set_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS_MS", "ITL_BUCKETS_MS", "get_registry",
           "reset_registry", "set_registry"]
