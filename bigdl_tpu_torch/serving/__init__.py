"""Online serving for the PyTorch port: bucketed forwards, micro-batching,
continuous-batching KV-cache decode (dense or paged, with the shared-prefix
cache), CUDA graphs of the serving path, watchdog and the HTTP surface."""

from bigdl_tpu_torch.serving.batcher import (AdmissionError, DeadlineExceeded,
                                             MicroBatcher, WorkerDied)
from bigdl_tpu_torch.serving.decode import DecodeEngine
from bigdl_tpu_torch.serving.engine import InferenceEngine
from bigdl_tpu_torch.serving.graphs import GraphPool
from bigdl_tpu_torch.serving.kv_pages import (PageAllocator, PagedKvCache,
                                              pages_needed)
from bigdl_tpu_torch.serving.metrics import MetricsRegistry
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.server import ServingApp, make_server, run_server
from bigdl_tpu_torch.serving.watchdog import Watchdog

__all__ = ["AdmissionError", "DeadlineExceeded", "DecodeEngine", "GraphPool",
           "InferenceEngine", "MetricsRegistry", "MicroBatcher",
           "PageAllocator", "PagedKvCache", "PrefixCache", "ServingApp",
           "Watchdog", "WorkerDied", "make_server", "pages_needed",
           "run_server"]
