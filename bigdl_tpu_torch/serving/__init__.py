"""Online serving for the PyTorch port: bucketed forwards, micro-batching,
continuous-batching KV-cache decode (dense or paged, with the shared-prefix
cache, speculative decoding and quantized weights and KV pools), CUDA
graphs of the serving path, watchdog and the HTTP surface."""

from bigdl_tpu_torch.serving.batcher import (AdmissionError, DeadlineExceeded,
                                             MicroBatcher, WorkerDied)
from bigdl_tpu_torch.serving.decode import DecodeEngine
from bigdl_tpu_torch.serving.engine import InferenceEngine
from bigdl_tpu_torch.serving.graphs import GraphPool
from bigdl_tpu_torch.serving.kv_pages import (PageAllocator, PagedKvCache,
                                              QuantPool, kv_quant_rows,
                                              pages_needed)
from bigdl_tpu_torch.serving.metrics import MetricsRegistry
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.quant import (QUANTIZE_CHOICES, QuantizedWeight,
                                           parse_quantize, quant_report,
                                           quantize_params)
from bigdl_tpu_torch.serving.server import ServingApp, make_server, run_server
from bigdl_tpu_torch.serving.spec_decode import (accept_chunk,
                                                 parse_draft_dims,
                                                 request_key, sample_token,
                                                 warp_logits)
from bigdl_tpu_torch.serving.watchdog import Watchdog

__all__ = ["AdmissionError", "DeadlineExceeded", "DecodeEngine", "GraphPool",
           "InferenceEngine", "MetricsRegistry", "MicroBatcher",
           "PageAllocator", "PagedKvCache", "PrefixCache", "QUANTIZE_CHOICES",
           "QuantPool", "QuantizedWeight", "ServingApp", "Watchdog",
           "WorkerDied", "accept_chunk", "kv_quant_rows", "make_server",
           "pages_needed", "parse_draft_dims", "parse_quantize",
           "quant_report", "quantize_params", "request_key", "run_server",
           "sample_token", "warp_logits"]
