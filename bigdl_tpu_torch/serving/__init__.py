"""Online serving for the PyTorch port: bucketed forwards, micro-batching,
continuous-batching KV-cache decode (dense or paged, with the shared-prefix
cache, speculative decoding and quantized weights and KV pools), CUDA
graphs of the serving path, request tracing with SLOs and an access log,
watchdog, the HTTP surface with streamed ``/generate``, and the
multi-process fleet (``serving.fleet``).

The names below load on first use: a fleet router imports
``serving.fleet.router`` and ``serving.reqtrace`` without loading torch,
so the front-door process never touches the card."""

import importlib

_EXPORTS = {
    "batcher": ("AdmissionError", "DeadlineExceeded", "MicroBatcher",
                "WorkerDied"),
    "decode": ("DecodeEngine",),
    "engine": ("InferenceEngine",),
    "graphs": ("GraphPool",),
    "kv_pages": ("PageAllocator", "PagedKvCache", "QuantPool",
                 "kv_quant_rows", "pages_needed"),
    "metrics": ("MetricsRegistry",),
    "prefix_cache": ("PrefixCache",),
    "quant": ("QUANTIZE_CHOICES", "QuantizedWeight", "parse_quantize",
              "quant_report", "quantize_params"),
    "server": ("ServingApp", "make_server", "run_server"),
    "spec_decode": ("accept_chunk", "parse_draft_dims", "request_key",
                    "sample_token", "warp_logits"),
    "watchdog": ("Watchdog",),
}
_OWNER = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_OWNER)


def __getattr__(name):
    mod = _OWNER.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
